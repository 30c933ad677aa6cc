"""Fault-tolerance machinery: straggler watchdog, preemption handling,
and the restartable trainer loop used by ``launch/train.py``.

Counterpart of ``repro.training.fault``.

* **node loss / preemption** — recovery is a restart from the last
  committed checkpoint.  ``run_training`` resumes exactly: the data is
  addressed by step (``training.data``), commits are atomic
  (``training.checkpoint``), and the restored state is the saved one bit
  for bit.  ``crash_at_step`` injects a failure after a step and before
  its checkpoint; an exception leaving the loop first joins the in-flight
  checkpoint write, so a restart in the same process finds it committed
  and no writer of the failed run races the restarted one.
* **stragglers** — the watchdog tracks a step-time EWMA; a step longer
  than ``threshold`` times the EWMA is recorded as a straggler event.  The
  serving engine feeds it every tick's duration too.
* **preemption signal** — SIGTERM sets a flag; the loop makes a final
  synchronous save at the next step boundary and stops.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class StragglerWatchdog:
    """Step-time EWMA + deadline detector."""

    alpha: float = 0.1           # EWMA smoothing
    threshold: float = 3.0       # multiple of EWMA that flags a straggler
    warmup_steps: int = 5        # first steps excluded (warm-up)
    ewma: Optional[float] = None
    _seen: int = 0
    events: List[Dict[str, float]] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if the step was straggler-slow."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self.ewma is None:
            self.ewma = seconds
            return False
        slow = seconds > self.threshold * self.ewma
        if slow:
            self.events.append({"step": step, "seconds": seconds, "ewma": self.ewma})
        else:
            # The EWMA leaves flagged outliers out, so one straggler does not mask the next.
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return slow

    @property
    def deadline_seconds(self) -> Optional[float]:
        return None if self.ewma is None else self.threshold * self.ewma


class PreemptionHandler:
    """SIGTERM -> graceful-save flag, checked at step boundaries."""

    def __init__(self, install: bool = True):
        self._requested = False
        self._prev = None
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:  # not the main thread
                self._prev = None

    def _on_signal(self, signum, frame):
        self._requested = True

    def request(self) -> None:  # test hook / manual trigger
        self._requested = True

    @property
    def requested(self) -> bool:
        return self._requested

    def restore(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


@dataclass
class TrainLoopReport:
    last_step: int
    losses: List[float]
    straggler_events: List[Dict[str, float]]
    preempted: bool
    resumed_from: Optional[int]
    step_seconds: List[float] = field(default_factory=list)
    checkpoints: List[Dict[str, Any]] = field(default_factory=list)


def run_training(
    *,
    step_fn: Callable[[Any, Dict[str, Any]], Any],
    state: Any,
    make_batch: Callable[[int], Dict[str, Any]],
    num_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    keep_last: int = 3,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    watchdog: Optional[StragglerWatchdog] = None,
    preemption: Optional[PreemptionHandler] = None,
    crash_at_step: Optional[int] = None,   # failure-injection test hook
) -> TrainLoopReport:
    """Restartable training loop.

    Resumes from the latest committed checkpoint in ``ckpt_dir`` when one
    exists; saves every ``ckpt_every`` steps (async), at preemption (sync)
    and at the end.  ``crash_at_step`` raises after the step that brings
    the count to it and before that count's checkpoint.  A step's time is
    taken up to reading its loss (which waits for the device); the report
    keeps each step's seconds beside its loss, and each asynchronous
    save's seconds and bytes (``AsyncCheckpointer.saves``)."""
    from repro_torch.training import checkpoint as CK

    watchdog = watchdog or StragglerWatchdog()
    preemption = preemption or PreemptionHandler(install=False)
    ckpt = CK.AsyncCheckpointer(ckpt_dir, keep_last=keep_last) if ckpt_dir else None

    start_step = 0
    resumed_from = None
    if ckpt_dir and CK.latest_step(ckpt_dir) is not None:
        start_step, state, _ = CK.restore_checkpoint(ckpt_dir, state)
        resumed_from = start_step
        log_fn(f"[fault] resumed from committed step {start_step}")

    losses: List[float] = []
    seconds: List[float] = []
    preempted = False
    step = start_step
    try:
        while step < num_steps:
            batch = make_batch(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            losses.append(loss)
            seconds.append(dt)
            if watchdog.observe(step, dt):
                log_fn(f"[fault] straggler: step {step} took {dt:.3f}s (ewma {watchdog.ewma:.3f}s)")
            if log_every and step % log_every == 0:
                log_fn(f"step {step:5d}  loss {loss:.4f}  ({dt*1e3:.1f} ms)")

            step += 1

            if crash_at_step is not None and step == crash_at_step:
                raise RuntimeError(f"injected failure at step {step}")

            if ckpt and step % ckpt_every == 0:
                ckpt.save(step, state)

            if preemption.requested:
                log_fn(f"[fault] preemption requested: sync save at step {step}")
                if ckpt:
                    ckpt.wait()
                    CK.save_checkpoint(ckpt_dir, step, state, keep_last=keep_last)
                preempted = True
                break
    except BaseException:
        if ckpt:
            ckpt.join()
        raise

    if ckpt:
        ckpt.wait()
        if not preempted and (step % ckpt_every != 0 or step == start_step):
            CK.save_checkpoint(ckpt_dir, step, state, keep_last=keep_last)

    return TrainLoopReport(
        last_step=step,
        losses=losses,
        straggler_events=watchdog.events,
        preempted=preempted,
        resumed_from=resumed_from,
        step_seconds=seconds,
        checkpoints=ckpt.saves if ckpt else [],
    )
