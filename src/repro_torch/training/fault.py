"""Fault tolerance: the straggler watchdog (counterpart of
``repro.training.fault.StragglerWatchdog``).

The watchdog tracks an EWMA of step times; a step longer than
``threshold`` times the EWMA is recorded as a straggler event.  The
serving engine feeds it every tick's duration.  The rest of the
reference's module (preemption handling, the restartable trainer loop)
belongs to the trainer and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


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
