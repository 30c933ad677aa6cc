"""Audit registry: what the auditor runs over, what each hot scope may
cost, and what it may ignore (counterpart of
``repro.analysis.registry``).

Four declarative tables, side by side so that adding a mode, raising a
budget or suppressing a finding is a one-line reviewed change here:

* the **audit matrix**: every (driver, mode, K) the session layer runs,
  taken as a census (:mod:`repro_torch.analysis.census`) at a small
  synthetic plan.  The reference's backend axis (``xla`` /
  ``pallas-interpret``) becomes one rule: a ``kernels.ops`` entry and a
  kernel workspace's ``step`` count one launch each, so the CPU's census
  is the card's.  Its counts do not depend on the plan's size
  (``tests/test_torch_census.py`` shows it at two sizes), so a small plan
  stands for the 512x512 slices;
* the **census budgets**: per (driver, mode) and scope, the declared
  counts, maxed over K (PT002 / PT005);
* the **suppressions**, each with its reason;
* the **kernel cases** the kernel pass runs on the card
  (:mod:`repro_torch.analysis.kernel_check`), and the calibration
  audit's probe ladders.

JX004 (donation candidates) has no eager counterpart: PyTorch reuses a
buffer only where the code writes it in place, and the port's in-place
reuse is pinned by the budget ledger's ``warm_execute`` and
``warm_tick`` phases (zero workspace builds), so there is no detector
for it (PT004 is reserved).

Standard library only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .findings import Suppression

__all__ = [
    "AUDIT_SIZE",
    "AUDIT_GRID",
    "AUDIT_BATCH",
    "AUDIT_TICK_ITERS",
    "AUDIT_MAX_EM_ITERS",
    "AUDIT_MAX_MAP_ITERS",
    "MODES",
    "KS",
    "DRIVERS",
    "census_budget",
    "PROGRAM_CARD",
    "PROGRAM_GRAPH",
    "SUPPRESSIONS",
    "KernelCase",
    "KERNEL_CASES",
    "CALIBRATION_PROBE_BUCKETS",
    "CALIBRATION_PROBE_WIDTHS",
]

#: The census's synthetic plan: a 32x32 image over a 4x4 oversegmentation
#: grid (bucket (512, 64, 64)), and the lanes of the batched and ticked
#: drivers.
AUDIT_SIZE = 32
AUDIT_GRID = 4
AUDIT_BATCH = 2
AUDIT_TICK_ITERS = 4
#: Four EM and four MAP iterations: the first past the window (WINDOW = 3)
#: in both loops, so every branch of a scope runs (the gated window test of
#: the MAP loop, the EM convergence test of the boundary) and the counts
#: are the most an instance takes.
AUDIT_MAX_EM_ITERS = 4
AUDIT_MAX_MAP_ITERS = 4

MODES: Tuple[str, ...] = ("faithful", "static", "static-pallas")
KS: Tuple[int, ...] = (2, 3, 5)
DRIVERS: Tuple[str, ...] = ("run_em", "run_em_batched", "run_em_ticked")

# ---------------------------------------------------------------------------
# Census budgets (PT002 / PT005).
#
# Measured with ``python -m repro_torch.analysis`` on the CPU (torch 2.13),
# the maximum over a scope's instances, maxed over K in {2, 3, 5}.  Every
# driver runs a compiled program, here its plain version, whose steps the
# census counts as the card launches them (``census``'s opaque workspace
# methods and control functions):
#   - map_iteration, run_em and run_em_batched, every mode: one launch (a
#     plain MAP iteration of the lanes: the tick's, or the modes' flat
#     step with its control, ``ref.map_ctl``) and one host read of the MAP
#     loop's condition word; no device op, no copy.  On the card these are
#     inside the graph (see PROGRAM_CARD).
#   - map_iteration, run_em_ticked, every mode: a micro-step of the plain
#     tick, run to ``tick_iters`` with the loop's condition as a mask: the
#     pool's step, the stop test (``ref.tick_stops``) and the tail
#     (``ref.tick_tail``), three launches; the mask's ten device ops (the
#     condition, three held words and their three selects and copies); no
#     host read, no copy.
#   - em_boundary, run_em and run_em_batched: one launch (the plain
#     boundary; in the modes with its M-step) and one read of the EM loop's
#     condition word.  run_em_ticked, every micro-step (the IF body under
#     its condition as a mask): the modes' M-step (one launch) and the
#     boundary kernel's lane form, and the mask's four device ops (the held
#     program words, the condition, a select and a copy); no host read, no
#     copy (the host-stepped tick copied the stopped lanes' words to the
#     device).
#   - solve (a program's solve outside its loops): run_em and
#     run_em_batched in mode static-pallas the element arrays (one
#     segment_reduce launch and their gathers), ``start`` (one copy of the
#     solve's arrays into the workspace), the program's start (the plain
#     init: one launch), one host read of the counters, and the result's
#     copies; in the modes ``start``, the plain init, the read and the two
#     copies of the result.  run_em_ticked: the tick's start
#     (``ref.tick_init``, its in-words from the host's lists) and the one
#     read of its words (``ref.tick_publish``).
# A (driver, mode) without a row is taken as a census with no gate (its
# entry's ``budget`` is null in the report).
# ---------------------------------------------------------------------------


def _row(map_iteration: Dict[str, int], em_boundary: Dict[str, int],
         solve: Optional[Dict[str, int]] = None) -> Dict[str, Dict[str, int]]:
    return {"map_iteration": map_iteration, "em_boundary": em_boundary, "solve": solve}


def _c(device_ops, scatters, gathers, launches, host_reads, h2d_copies) -> Dict[str, int]:
    return dict(device_ops=device_ops, scatters=scatters, gathers=gathers, launches=launches,
                host_reads=host_reads, h2d_copies=h2d_copies)


#                                   map_iteration:                  em_boundary:
#                                   ops  sc ga la hr h2d            ops sc ga la hr h2d
#                                   (solve after them)
_MODES_PROGRAM = _row(_c(0, 0, 0, 1, 1, 0), _c(0, 0, 0, 1, 1, 0), _c(3, 0, 0, 1, 1, 0))
_BUDGETS: Dict[Tuple[str, str], Dict[str, Dict[str, int]]] = {
    ("run_em", "faithful"): _MODES_PROGRAM,
    ("run_em_batched", "faithful"): _MODES_PROGRAM,
    ("run_em", "static"): _MODES_PROGRAM,
    ("run_em_batched", "static"): _MODES_PROGRAM,
    ("run_em", "static-pallas"): _row(_c(0, 0, 0, 1, 1, 0), _c(0, 0, 0, 1, 1, 0),
                                      _c(9, 0, 3, 2, 1, 0)),
    ("run_em_batched", "static-pallas"): _row(_c(0, 0, 0, 1, 1, 0), _c(0, 0, 0, 1, 1, 0),
                                              _c(13, 0, 3, 2, 1, 0)),
    **{("run_em_ticked", mode): _row(_c(10, 0, 0, 3, 0, 0),
                                     _c(4, 0, 0, 1 if mode == "static-pallas" else 2, 0, 0),
                                     _c(0, 0, 0, 1, 1, 0))
       for mode in MODES},
}


def census_budget(driver: str, mode: str) -> Optional[Dict[str, Dict[str, int]]]:
    return _BUDGETS.get((driver, mode))


# ---------------------------------------------------------------------------
# The compiled programs on the card: every mode's run_em and run_em_batched,
# and every mode's run_em_ticked (a tick).
#
# The CPU's census above is the plain programs': their loops on the host.
# On the card the loops are conditional nodes of one CUDA graph, where no
# host sees them, so a warm call's census there has no map_iteration and no
# em_boundary instance, and its solve scope counts one graph launch and one
# host read (the mapped result words), no copy and no build.  In mode
# static-pallas the solve also has the neighbourhood sizes' segment_reduce
# (2 launches) and its device operations are the CPU's solve's plus the
# labels' gather by the device's parity words (``.long()`` and an index).
# In the modes: ``start``, the labels' copy and the result's (3 device
# ops).  A tick: its launch and its read alone.  Inside the graph
# (``chip_smoke.py``'s ``program`` phase): one step per lockstep MAP
# iteration (the tick's launch, or the modes' captured flat step and its
# control kernel), one boundary launch per lockstep EM iteration (after
# the modes' captured M-step), one init launch per solve; a tick runs its
# init, per micro-step the pool's step, the stop test and the tail, the
# boundary (after the modes' M-step) in the micro-steps where some lane
# stopped, and the publish; no host read.
# ---------------------------------------------------------------------------
_CARD_TICK = {"map_iteration": None, "em_boundary": None, "solve": _c(0, 0, 0, 1, 1, 0)}
_CARD_MODES = {"map_iteration": None, "em_boundary": None, "solve": _c(3, 0, 0, 1, 1, 0)}
PROGRAM_CARD: Dict[Tuple[str, str], Dict[str, Optional[Dict[str, int]]]] = {
    ("run_em", "static-pallas"): {"map_iteration": None, "em_boundary": None,
                                  "solve": _c(11, 0, 4, 2, 1, 0)},
    ("run_em_batched", "static-pallas"): {"map_iteration": None, "em_boundary": None,
                                          "solve": _c(15, 0, 4, 2, 1, 0)},
    **{(driver, mode): _CARD_MODES for driver in ("run_em", "run_em_batched")
       for mode in ("static", "faithful")},
    **{("run_em_ticked", mode): _CARD_TICK for mode in MODES},
}
#: Kernel launches inside one replay of a program's graph.
PROGRAM_GRAPH = {"tick_per_map_iteration": 1, "boundary_per_em_iteration": 1,
                 "init_per_solve": 1, "host_reads": 0}
#: And of a tick's graph (per micro-step; the boundary per micro-step in
#: which some lane stopped).
TICK_GRAPH = {"init_per_tick": 1, "step_per_micro_step": 1, "stops_per_micro_step": 1,
              "tail_per_micro_step": 1, "publish_per_tick": 1, "host_reads": 0}


# ---------------------------------------------------------------------------
# Suppressions: every exemption cites its reason.
# ---------------------------------------------------------------------------
#: None: every driver's float64 rounding (the EM boundary's, deliberate:
#: ``energy.params_from_stats`` and ``em._total_energy`` each round once)
#: now runs inside the boundary kernel or its plain version, which the
#: census counts as one opaque launch; the modes' host boundary that made
#: it visible (the suppression this tuple held) is the sharded route's alone, which
#: the census does not take.
SUPPRESSIONS: Tuple[Suppression, ...] = ()

# ---------------------------------------------------------------------------
# Kernel cases (the kernel pass, KC codes).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelCase:
    """One call of a kernel entry on the card at a small shape."""

    name: str                    # "em_tick/solve/K=2/f32"
    kernel: str                  # the csrc source: "em_tick"
    entries: Tuple[str, ...]     # the C entry points the call launches
    run: str                     # the runner in kernel_check (CASE_RUNNERS)
    params: Tuple[Tuple[str, object], ...] = field(default_factory=tuple)


def _case(name, kernel, entries, run, **params) -> KernelCase:
    return KernelCase(name, kernel, tuple(entries), run, tuple(sorted(params.items())))


_TICK_SOLVE = ("repro_em_tick_step",)
_PROGRAM = ("repro_em_program_build", "repro_em_program_launch")
_NODES = ("repro_prog_node", "repro_em_program_launch")
KERNEL_CASES: Tuple[KernelCase, ...] = (
    # The tick: its JAX-signature entry, one problem's host-stepped solve
    # (step and the launch that stops each MAP loop), a host-stepped stack
    # and a pool, at the templated K (2, 3) and the runtime-K variant (9),
    # in f32 and bf16.
    *(_case(f"em_tick/jax_signature/K={k}/{p}", "em_tick", ("repro_fused_em_tick",),
            "tick_jax_signature", k=k, precision=p)
      for k in (2, 3, 9) for p in ("f32", "bf16")),
    *(_case(f"em_tick/solve/K={k}/{p}", "em_tick", _TICK_SOLVE, "tick_solve", k=k, precision=p)
      for k, p in ((2, "f32"), (2, "bf16"), (3, "f32"), (9, "f32"))),
    *(_case(f"em_tick/stack/K={k}", "em_tick", ("repro_em_tick_step_batched",), "tick_stack", k=k)
      for k in (2, 9)),
    # The compiled EM program (one graph: the tick's lane entry and the
    # boundary kernel in conditional loops): a solve through the session and
    # a stack through drain; the boundary kernel's two entries standalone;
    # the graph probe.
    *(_case(f"em_program/solve/K={k}/{p}", "em_tick", _PROGRAM, "program_solve", k=k,
            precision=p) for k, p in ((2, "f32"), (2, "bf16"), (3, "f32"), (9, "f32"))),
    *(_case(f"em_program/stack/K={k}", "em_tick", _PROGRAM, "program_stack", k=k)
      for k in (2, 9)),
    _case("em_boundary/single", "em_tick", ("repro_em_boundary",), "em_boundary", lanes=False),
    _case("em_boundary/lanes", "em_tick", ("repro_em_boundary_lanes",), "em_boundary", lanes=True),
    _case("em_program/graph_probe", "em_tick", ("repro_em_graph_probe",), "graph_probe"),
    *(_case(f"em_tick/pool/K={k}", "em_tick", ("repro_em_tick_step_pool",), "tick_pool", k=k)
      for k in (2, 3)),
    # The programs assembled node by node: a pool's compiled tick (K = 2,
    # 3), and the control kernels standalone.  The modes' programs capture
    # PyTorch ops into a private memory pool, which the guard fallback's
    # pluggable allocator cannot give, so their graphs run in no case: their
    # parts do, a whole DPP stack solve of uncaptured steps, map_ctl and
    # boundaries on the stack's words.
    *(_case(f"em_program/pool_tick/K={k}", "em_tick", _NODES, "program_pool_tick", k=k)
      for k in (2, 3)),
    _case("em_control/standalone", "em_tick", ("repro_prog_launch_kind",), "control_kernels"),
    *(_case(f"em_program/modes_parts/{m}", "em_tick",
            ("repro_prog_launch_kind", "repro_em_boundary_lanes", "repro_segment_reduce_f32",
             "repro_segment_reduce_ordered_f32"), "modes_parts", mode=m)
      for m in ("static", "faithful")),
    # The sharded route's MAP step: the JAX-signature entry and the
    # workspace's iteration (steps, and the launch that only tests).
    *(_case(f"map_step/jax_signature/K={k}", "map_step", ("repro_fused_map_step",),
            "map_step_jax_signature", k=k) for k in (2, 3)),
    *(_case(f"map_step/iteration/K={k}", "map_step", ("repro_map_step_iteration",),
            "map_step_iteration", k=k) for k in (2, 3, 9)),
    *(_case(f"mrf_energy/n={n}", "mrf_energy", ("repro_mrf_min_energy",), "mrf_min_energy", n=n)
      for n in (1, 4097)),
    _case("segment_reduce/add", "segment_reduce", ("repro_segment_reduce_f32",),
          "segment_reduce", op="add", ordered=False),
    _case("segment_reduce/min", "segment_reduce", ("repro_segment_reduce_f32",),
          "segment_reduce", op="min", ordered=False),
    _case("segment_reduce/ordered_add", "segment_reduce", ("repro_segment_reduce_ordered_f32",),
          "segment_reduce", op="add", ordered=True),
    # Flash: the bf16 tensor-core kernel at D = 64 and 128, and f32.
    _case("flash_attention/bf16/D=64", "flash_attention", ("repro_flash_attention",),
          "flash_attention", dtype="bf16", d=64, causal=True),
    _case("flash_attention/bf16/D=128", "flash_attention", ("repro_flash_attention",),
          "flash_attention", dtype="bf16", d=128, causal=False),
    _case("flash_attention/f32/D=64", "flash_attention", ("repro_flash_attention",),
          "flash_attention", dtype="f32", d=64, causal=True),
)

# ---------------------------------------------------------------------------
# Calibration audit probes (CT codes): the cost model's predictions must
# be monotone non-decreasing along each ladder (capacity, with each dim
# scaling together; label count K; lockstep width).  The reference's.
# ---------------------------------------------------------------------------
CALIBRATION_PROBE_BUCKETS: Tuple[Tuple[int, int, int], ...] = (
    (4096, 256, 192),
    (8192, 512, 384),
    (16384, 1024, 768),
    (65536, 4096, 4096),
)
CALIBRATION_PROBE_WIDTHS: Tuple[int, ...] = (1, 2, 4, 8)
