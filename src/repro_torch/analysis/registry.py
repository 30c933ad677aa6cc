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
# the maximum over a scope's instances, maxed over K in {2, 3, 5}:
#   - map_iteration, static-pallas: one launch and one host read, no
#     device op, no copy, in every driver: run_em and run_em_batched run
#     the compiled EM program, here its plain version (one plain MAP
#     iteration of the lanes and one read of the MAP loop's condition word;
#     on the card these are inside the graph, see PROGRAM_CARD);
#     run_em_ticked one launch of the pool entry and one read of the flag
#     words.
#   - map_iteration, static / faithful: the paper's primitive sequence:
#     one problem 97-165 device ops (growing with K: the per-label
#     energies), a stack or pool's flat step 107-133 whatever K; three
#     segment_reduce launches (four in faithful: its ReduceByKey(Min)), the
#     votes' one scatter, one host read (the window and finiteness test,
#     em.py's ``tolist``, or the lanes' flag words); no copy.
#   - em_boundary: the M-step (the modes take three ordered ``add``
#     launches; the pool reads the stopping launch's sums), the tests, the
#     total-energy ring and one host read.  The batched and ticked
#     boundaries also copy from the host which lanes go on (an
#     ``as_tensor`` of a list, a ``to`` of a host mask).  The pool's
#     (run_em_ticked, every mode) is one launch of the boundary kernel's
#     lane form over the pool (the modes' pools first take their M-step
#     sums, three ordered ``add``), from one copy of the stopped lanes'
#     words to the device, then one read of the words it wrote and the
#     next EM iteration's start of the lanes that go on.  The program's
#     (static-pallas run_em, run_em_batched): one launch of the plain
#     boundary and one read of the EM loop's condition word, no device op.
#   - solve (the compiled program's solve outside its loops, static-pallas
#     run_em and run_em_batched): the element arrays (one segment_reduce
#     launch and their gathers), ``start`` (one copy of the solve's arrays
#     into the workspace), the program's start (the plain init: one
#     launch), one host read of the counters, and the result's copies.
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
#                                   (solve, where a row has it, after them)
_BUDGETS: Dict[Tuple[str, str], Dict[str, Dict[str, int]]] = {
    ("run_em", "faithful"): _row(_c(165, 1, 8, 4, 1, 0), _c(65, 0, 2, 3, 1, 0)),
    ("run_em_batched", "faithful"): _row(_c(129, 1, 8, 4, 1, 0), _c(79, 0, 2, 3, 1, 2)),
    ("run_em_ticked", "faithful"): _row(_c(133, 1, 8, 4, 1, 0), _c(28, 5, 5, 4, 1, 3)),
    ("run_em", "static"): _row(_c(151, 1, 6, 3, 1, 0), _c(62, 0, 0, 3, 1, 0)),
    ("run_em_batched", "static"): _row(_c(107, 1, 6, 3, 1, 0), _c(76, 0, 0, 3, 1, 2)),
    ("run_em_ticked", "static"): _row(_c(111, 1, 6, 3, 1, 0), _c(25, 5, 3, 4, 1, 3)),
    ("run_em", "static-pallas"): _row(_c(0, 0, 0, 1, 1, 0), _c(0, 0, 0, 1, 1, 0),
                                      _c(9, 0, 3, 2, 1, 0)),
    ("run_em_batched", "static-pallas"): _row(_c(0, 0, 0, 1, 1, 0), _c(0, 0, 0, 1, 1, 0),
                                              _c(13, 0, 3, 2, 1, 0)),
    ("run_em_ticked", "static-pallas"): _row(_c(0, 0, 0, 1, 1, 0), _c(6, 0, 3, 1, 1, 2)),
}


def census_budget(driver: str, mode: str) -> Optional[Dict[str, Dict[str, int]]]:
    return _BUDGETS.get((driver, mode))


# ---------------------------------------------------------------------------
# The compiled EM program on the card (static-pallas run_em, run_em_batched).
#
# The CPU's census above is the plain program's: its loops on the host.  On
# the card the loops are conditional nodes of one CUDA graph, where no host
# sees them, so a warm solve's census there has no map_iteration and no
# em_boundary instance, and its solve scope counts the graph launch and the
# neighbourhood sizes' segment_reduce (2 launches) and one host read (the
# mapped result words).  Its device operations are the CPU's solve's, plus
# the labels' gather by the device's parity words (``.long()`` and an
# index).  Inside the graph (``chip_smoke.py``'s profiler, ``program``
# phase): one tick launch per lockstep MAP iteration, one boundary launch
# per lockstep EM iteration, one init launch per solve, no host read.
# ---------------------------------------------------------------------------
PROGRAM_CARD: Dict[Tuple[str, str], Dict[str, Optional[Dict[str, int]]]] = {
    ("run_em", "static-pallas"): {"map_iteration": None, "em_boundary": None,
                                  "solve": _c(11, 0, 4, 2, 1, 0)},
    ("run_em_batched", "static-pallas"): {"map_iteration": None, "em_boundary": None,
                                          "solve": _c(15, 0, 4, 2, 1, 0)},
}
#: Kernel launches inside one replay of the program's graph.
PROGRAM_GRAPH = {"tick_per_map_iteration": 1, "boundary_per_em_iteration": 1,
                 "init_per_solve": 1, "host_reads": 0}


# ---------------------------------------------------------------------------
# Suppressions: every exemption cites its reason.
# ---------------------------------------------------------------------------
SUPPRESSIONS: Tuple[Suppression, ...] = (
    Suppression(
        code="PT001",
        site_pattern="run_em*/em_boundary",
        reason=(
            "deliberate: the EM boundary rounds twice through float64 to fix "
            "its bits whatever the device's reduction order: "
            "energy.params_from_stats forms E[y^2] - mu^2 with one rounding "
            "(float32 operands are exact in float64, as the reference's "
            "fused multiply-add forms it) and em._total_energy sums the hood "
            "energies in float64 and rounds once; both round back to float32 "
            "at once and neither runs in a MAP iteration"
        ),
    ),
)

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
