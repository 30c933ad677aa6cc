"""CUDA EM tick: ``csrc/em_tick.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.em_tick.fused_em_tick_pallas``: the whole
tick of the static-pallas route (counts, energies, min/argmin, hood sums,
votes, labels, M-step sums, convergence flag) in one launch on the
current stream, for any K from 2 to ``MAX_LABELS``.  The kernel walks
each hood as a contiguous run of the (hood, vertex)-sorted element
arrays, so it takes ``offsets``, the (n_hoods + 1,) run boundaries
(``Hoods.offsets``).  Three entry points launch the same kernel body:

* :class:`TickWorkspace`, the EM driver's: built from a bucket's shapes
  alone (``ref.TickShape``: all buffers, the solve's inputs too) and the
  EM limits, with its compiled EM program (:class:`SolveGraph`: the whole
  solve as one CUDA graph, the tick's lane entry at B = 1 and the EM
  boundary kernel of ``csrc/em_boundary.cuh`` in two conditional loops);
  :meth:`~TickWorkspace.start` checks a solve's operands and copies them
  in, ``run_program`` launches the graph, ``program_result`` reads the
  counters with one wait.  Host-stepped, it runs one MAP iteration per
  :meth:`~TickWorkspace.step` (one launch of the single entry, its
  controls from the host) and reads the flag word with one wait in
  :meth:`~TickWorkspace.flag`.  ``ref.PlainTickWorkspace`` is its plain
  version.
* :class:`BatchTickWorkspace`, the batched driver's: the same for a stack
  of B problems padded to one bucket, one launch of the lane entry per
  lockstep MAP iteration for every lane still running, in its graph or
  host-stepped (one wait for the B flag words).
  ``ref.PlainBatchTickWorkspace`` is its plain version.
* :class:`PoolTickWorkspace`, the continuous-batching driver's
  (``em.run_em_ticked``): a pool of B slots that owns its lanes' inputs
  and EM level, whose lanes sit at different MAP iterations; one launch
  per micro-step runs every active lane's own next iteration (the
  kernel's per-lane MAP counters).  Built with the EM limits it holds the
  compiled tick (:class:`TickProgram`: one graph launch and one wait per
  tick); host-stepped, one wait reads the B flag words after each launch.
  Slot writes (``admit``, ``begin_lanes``, ``retire``) touch only that
  slot's rows.
  ``ref.PlainPoolTickWorkspace`` is its plain version.
* :func:`fused_em_tick_cuda`, with the JAX kernel's signature (``xf`` and
  ``hist`` given), allocating its outputs per call.  ``ref.fused_em_tick``
  is its plain version.

The pool's compiled tick and the modes' programs are assembled node by
node (:class:`ProgramBuilder`, ``repro_prog_*``): :class:`TickProgram`, a
served pool's tick as one graph (the control kernels of
``csrc/em_control.cuh`` around the pool's step and, in an IF node, the
boundary kernel's lane form; built with the pool), and
:class:`ModesProgram`, a solve or stack of the modes ``static`` and
``faithful`` (the solve's graph with their flat step and M-step, PyTorch ops
captured once as :class:`CapturedOps` and cloned in as child graphs).

:func:`em_boundary_cuda` launches the boundary kernel alone (its single or
lane form; ``ref.em_boundary``/``em_boundary_lanes``),
:class:`ControlKernels` the control kernels alone, and :func:`graph_probe`
the card's nested conditional graph probe.

The kernel adds each hood's energies in the plain versions' element
order and its M-step sums in vertex order, at every K
(``csrc/plainsum.cuh``); a workspace step takes the M-step sums only in
the launch that stops the MAP loop (its flag word set, or ``cap``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import segment_reduce as _segment_reduce
from repro_torch.kernels.ref import FLAG_CONVERGED, FLAG_DIVERGED  # noqa: F401 (bits of the flag word)
from repro_torch.kernels.ref import TickShape

#: Most labels the kernel takes (5,282).  K = 2..8 are template
#: instantiations; any larger K runs a runtime-K variant whose hood pass
#: holds 3 K per-label terms and K counts for each of its 8 warps in shared
#: memory: 44 K bytes a block, within the 227 KB (232,448 bytes) a block
#: may use on an H100.
SMEM_PER_BLOCK = 232_448
MAX_LABELS = SMEM_PER_BLOCK // (4 * (3 + 8))

#: Launches of the kernel in this process (``ops.launch_counts``), and
#: how many of them were the batched entry's and the pool entry's.  The
#: launches a compiled program makes inside its graph are counted when the
#: solve's result is read (``program_result``): the tick's (the lockstep
#: MAP iterations) here and, for a stack, in ``launches_batched``; the EM
#: boundary's (one per lockstep EM iteration) in ``launches_boundary``,
#: beside those of its standalone entries; the graph launches themselves
#: in ``launches_graph``.
launches = 0
launches_batched = 0
launches_pool = 0
launches_boundary = 0
launches_graph = 0
#: The control kernels' launches inside programs (``csrc/em_control.cuh``),
#: as each kernel counted itself on the device, added when a program's
#: result is read (``ops.control_launch_counts``).
launches_control = dict.fromkeys(("tick_init", "tick_stops", "tick_tail", "tick_publish",
                                  "map_ctl"), 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _P, _P,    # y, w, nall, xf, valid, vertex, offsets
    _P, _P, _P, _I,                # region_mean, region_weight, hist, hist_rows
    _P, _P, _P,                    # mu, sigma, beta
    _I, _I, _I, _I, ctypes.c_float,  # n_hoods, n_vertices, n_labels, bf16, conv_tol
    _P, _P, _P, _P, _P, _P,        # labels, hood_e, votes, stats, flag, sync
    _P,                            # stream
]


class _TickPlan(ctypes.Structure):
    """``struct TickPlan`` of ``csrc/em_tick.cu``, field for field."""

    _fields_ = [
        *((name, _P) for name in (
            "y", "w", "nall", "valid", "vertex", "offsets", "region_mean",
            "region_weight", "mu", "sigma", "beta")),
        ("labels", _P * 2),
        ("votes", _P * 2),
        *((name, _P) for name in (
            "ring", "hood_e", "stats", "sync", "flag_dev", "flag_host_dev", "flag_host",
            "stream")),
        *((name, _I) for name in (
            "hist_rows", "n_hoods", "n_vertices", "n_labels", "bf16", "device")),
        ("conv_tol", ctypes.c_float),
    ]


class _TickBatchPlan(ctypes.Structure):
    """``struct TickBatchPlan`` of ``csrc/em_tick.cu``, field for field."""

    _fields_ = [
        *((name, _P) for name in (
            "y", "w", "nall", "valid", "vertex", "offsets", "region_mean", "region_weight",
            "mu", "sigma", "beta", "labels", "votes", "ring", "hood_e", "stats", "sync",
            "flag_dev", "flag_host_dev", "flag_host", "parity", "active", "map_i", "stream")),
        *((name, _I) for name in (
            "batch", "capacity", "hist_rows", "n_hoods", "n_vertices", "n_labels", "bf16",
            "device", "max_map_iters")),
        ("conv_tol", ctypes.c_float),
        ("map_live", _P),
        ("map_cond", ctypes.c_ulonglong),
        ("conditional", _I),
        ("launch_count", _P),
    ]


#: ``argtypes`` of the C entry points of ``csrc/em_tick.cu``.
_SIGNATURES = {
    "repro_fused_em_tick": _ARGTYPES,
    "repro_em_tick_step": [_P, _I, _I, _I, _I],     # plan, parity, head, gate, cap
    "repro_em_tick_step_batched": [_P, _I, _I, _I],  # plan, head, gate, cap
    "repro_em_tick_step_pool": [_P],                # plan (per-lane controls)
    "repro_em_tick_wait": [_P, _P],                 # plan, flag out
    "repro_em_tick_wait_batched": [_P, _P],         # plan, B flags out
    "repro_em_tick_host_word": [_P, _P, _I],        # host, device address out, words
    "repro_em_program_build": [_P, _P, _P],         # tick plan, program plan, graph out
    "repro_em_program_launch": [_P, _P],            # graph, stream
    "repro_em_program_wait": [_P, _P, _I, _P],      # stream, host words, n, out
    "repro_em_boundary": [_P, _P],                  # program plan (B = 1), stream
    "repro_em_boundary_lanes": [_P, _P],            # program plan, stream
    "repro_em_graph_probe": [_I, _I, _P, _P, _P],   # outer, inner, versions, counts, stage out
    "repro_prog_new": [_I, _P],                     # device, builder out
    "repro_prog_handle": [_P, _I, ctypes.c_uint, _I, _P],  # builder, graph, default, assign, out
    "repro_prog_conditional": [_P, _I, ctypes.c_ulonglong, _I, _P],  # builder, graph, handle, type, body out
    "repro_prog_child": [_P, _I, _P],               # builder, graph, cudaGraph_t
    "repro_prog_node": [_P, _I, _I, _P],            # builder, graph, kind, plan
    "repro_prog_finish": [_P, _P],                  # builder, program out
    "repro_prog_abandon": [_P],                     # builder
    "repro_prog_launch_kind": [_I, _P, _P],         # kind, plan, stream
}


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    return _build.function("em_tick", symbol, _SIGNATURES[symbol])


_require = functools.partial(_build.require, "fused_em_tick_cuda")
_require_ws = functools.partial(_build.require, "TickWorkspace")
_require_batch = functools.partial(_build.require, "BatchTickWorkspace")
_require_pool = functools.partial(_build.require, "PoolTickWorkspace")


def _check_labels(fn: str, n_labels: int) -> None:
    if not 2 <= n_labels <= MAX_LABELS:
        raise ValueError(
            f"{fn} takes 2..{MAX_LABELS} labels, got {n_labels}: above that "
            f"the hood pass's shared memory passes the {SMEM_PER_BLOCK} bytes (227 KB) "
            "a block may use on an H100"
        )


def _check_precision(precision: str) -> None:
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}; have ('f32', 'bf16')")


def fused_em_tick_cuda(
    y: torch.Tensor,
    w: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    valid: torch.Tensor,
    hood_id: torch.Tensor,
    vertex: torch.Tensor,
    region_mean: torch.Tensor,
    region_weight: torch.Tensor,
    hist: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    offsets: torch.Tensor,
    n_hoods: int,
    n_vertices: int,
    precision: str = "f32",
    conv_tol: float = 1.0e-4,
) -> Tuple[torch.Tensor, ...]:
    """Launch the tick; returns ``(labels, hood_e, votes, conv, sum_w,
    sum_wy, sum_wyy)`` like ``ref.fused_em_tick``.

    Element arrays are (H,) float32 (int32 for ``hood_id``/``vertex``),
    sorted so that hood ``h`` owns elements ``offsets[h]:offsets[h+1]``
    (``offsets`` int32, non-decreasing, within ``[0, H]``).  ``hood_id`` is
    checked but not read: the run boundaries carry the hood of each element.
    ``hist`` (newest row first) is read, never written.
    """
    global launches
    _check_precision(precision)
    n_labels = int(mu.shape[0])
    _check_labels("fused_em_tick_cuda", n_labels)
    if not y.is_cuda:
        raise ValueError(f"fused_em_tick_cuda needs CUDA tensors, got {y.device}")
    dev = y.device
    h = int(y.shape[0])
    f32, i32 = torch.float32, torch.int32
    for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("xf", xf), ("valid", valid)):
        _require(t, name, f32, (h,), dev)
    _require(hood_id, "hood_id", i32, (h,), dev)
    _require(vertex, "vertex", i32, (h,), dev)
    _require(offsets, "offsets", i32, (n_hoods + 1,), dev)
    _require(region_mean, "region_mean", f32, (n_vertices,), dev)
    _require(region_weight, "region_weight", f32, (n_vertices,), dev)
    if hist.dim() != 2 or hist.shape[0] < 2:
        raise ValueError(f"fused_em_tick_cuda: hist must be (rows >= 2, n_hoods), got {tuple(hist.shape)}")
    _require(hist, "hist", f32, (hist.shape[0], n_hoods), dev)
    _require(mu, "mu", f32, (n_labels,), dev)
    _require(sigma, "sigma", f32, (n_labels,), dev)
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev).reshape(1).contiguous()

    labels = torch.empty((n_vertices,), dtype=i32, device=dev)
    hood_e = torch.empty((n_hoods,), dtype=f32, device=dev)
    votes = torch.zeros((n_labels, n_vertices), dtype=f32, device=dev)
    stats = torch.empty((3, n_labels), dtype=f32, device=dev)
    flag_sync = torch.zeros((3,), dtype=i32, device=dev)  # flag, then ticket and accumulator
    kernel = _entry("repro_fused_em_tick")
    with torch.cuda.device(dev):
        kernel(
            y.data_ptr(), w.data_ptr(), nall_e.data_ptr(), xf.data_ptr(),
            valid.data_ptr(), vertex.data_ptr(), offsets.data_ptr(),
            region_mean.data_ptr(), region_weight.data_ptr(), hist.data_ptr(),
            int(hist.shape[0]), mu.data_ptr(), sigma.data_ptr(), beta_t.data_ptr(),
            n_hoods, n_vertices, n_labels, int(precision == "bf16"), float(conv_tol),
            labels.data_ptr(), hood_e.data_ptr(), votes.data_ptr(),
            stats.data_ptr(), flag_sync.data_ptr(), flag_sync[1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    conv = (flag_sync[0] & FLAG_CONVERGED) != 0
    return labels, hood_e, votes, conv, stats[0], stats[1], stats[2]


def em_boundary_cuda(state: ref.BoundaryState, *, max_em_iters: int, max_map_iters: int,
                     conv_tol: float = 1.0e-4, lanes: bool = False) -> None:
    """The boundary kernel outside a program, in place on ``state``'s CUDA
    tensors (``ref.BoundaryState``; with ``lanes`` the lane form, else the
    single form, one problem without the lane axis): one launch on the
    current stream, no loop condition set.  The contract is
    ``ref.em_boundary`` / ``ref.em_boundary_lanes``."""
    global launches_boundary
    st = state if lanes else state.lanes()
    dev = st.hood_e.device
    if not st.hood_e.is_cuda:
        raise ValueError(f"em_boundary_cuda needs CUDA tensors, got {dev}")
    batch, k = int(st.em_mu.shape[0]), int(st.em_mu.shape[1])
    nh, rows = int(st.hood_e.shape[1]), int(st.total_hist.shape[1])
    f32, i32 = torch.float32, torch.int32
    req = functools.partial(_build.require, "em_boundary_cuda")
    for name, shape in (("stats", (batch, 3, k)), ("hood_e", (batch, nh)), ("em_mu", (batch, k)),
                        ("em_sigma", (batch, k)), ("mu", (batch, k)), ("sigma", (batch, k)),
                        ("ring", (batch, rows, nh)), ("total_hist", (batch, rows)),
                        ("sigma_min", (batch,)), ("reseed_mu", (batch, k)),
                        ("reseed_sigma", (batch,))):
        req(getattr(st, name), name, f32, shape, dev)
    req(st.lane, "lane", i32, (len(ref.LANE_WORDS), batch), dev)
    req(st.ctl, "ctl", i32, (len(ref.CTL_WORDS),), dev)
    g = program_plan(st, max_em_iters=max_em_iters, max_map_iters=max_map_iters, conv_tol=conv_tol)
    entry = _entry("repro_em_boundary_lanes" if lanes else "repro_em_boundary")
    with torch.cuda.device(dev):
        entry(ctypes.addressof(g), torch.cuda.current_stream(dev).cuda_stream)
    launches_boundary += 1


def graph_probe(n_outer: int = 3, n_inner: int = 5) -> dict:
    """The card's graph support (``repro_em_graph_probe``): the driver's and
    the runtime's CUDA versions and the counts of a graph with a
    conditional WHILE node nested in another, launched twice (each launch
    must run ``n_outer`` x ``n_inner`` steps and ``n_outer`` outer
    iterations)."""
    versions, counts, where = (ctypes.c_int * 2)(), (ctypes.c_int * 4)(), ctypes.c_int(0)
    _entry("repro_em_graph_probe")(n_outer, n_inner, ctypes.addressof(versions),
                                   ctypes.addressof(counts), ctypes.addressof(where))
    return {"driver_version": versions[0], "runtime_version": versions[1],
            "counts": list(counts), "want": [n_outer * n_inner, n_outer] * 2}


class _HostWord:
    """``n`` words of pinned host memory mapped into the card's address
    space, zeroed, freed with the object."""

    host = None

    def __init__(self, n: int = 1):
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _entry("repro_em_tick_host_word")(ctypes.addressof(host), ctypes.addressof(dev), n)
        self.host, self.device = host.value, dev.value
        self._free = _build.load("em_tick").repro_em_tick_free_host_word
        self._free.argtypes = [_P]

    def __del__(self):
        if self.host:
            self._free(self.host)
            self.host = None


def _check_shape(fn: str, shape: TickShape, precision: str, device) -> torch.device:
    _check_precision(precision)
    _check_labels(fn, shape.n_labels)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs a CUDA device, got {dev}")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def _check_problem(require, shape: TickShape, hoods, model, lead: tuple, dev) -> None:
    """The solve's hoods and model against the bucket's shapes (with the
    leading ``lead`` axes of a stack)."""
    f32, i32 = torch.float32, torch.int32
    if hoods.offsets is None:
        raise ValueError("a tick workspace needs the hoods' offsets (a whole problem, not a shard)")
    if (hoods.n_hoods, hoods.n_regions + 1, model.n_labels) != shape[1:]:
        raise ValueError(
            f"hoods of {hoods.n_hoods} hoods, {hoods.n_regions + 1} vertices and K = "
            f"{model.n_labels}; the workspace was built for {shape}"
        )
    require(hoods.vertex, "vertex", i32, lead + (shape.capacity,), dev)
    require(hoods.offsets, "offsets", i32, lead + (shape.n_hoods + 1,), dev)
    require(model.region_mean, "region_mean", f32, lead + (shape.n_vertices,), dev)
    require(model.region_weight, "region_weight", f32, lead + (shape.n_vertices,), dev)


class Program:
    """A compiled program's owner: its instantiated CUDA graph (freed with
    the object) and what its nodes need alive, the captured PyTorch ops
    (:class:`CapturedOps`) whose memory pools hold their temporaries.
    ``launch`` replays it on a stream: one graph launch."""

    ptr = None

    def __init__(self, ptr, keep=()):
        self.ptr, self.keep = ptr, tuple(keep)
        self._launch = _entry("repro_em_program_launch")
        self._destroy = _build.load("em_tick").repro_em_program_destroy
        self._destroy.argtypes = [_P]

    def launch(self, stream: int) -> None:
        self._launch(self.ptr, stream)

    def __del__(self):
        if self.ptr:
            self._destroy(self.ptr)
            self.ptr = None


class SolveGraph(Program):
    """A static-pallas workspace's compiled EM program
    (``repro_em_program_build``): one graph launch per solve."""

    def __init__(self, tick_plan: "_TickBatchPlan", prog_plan: "_ProgramPlan"):
        out = ctypes.c_void_p()
        _entry("repro_em_program_build")(ctypes.addressof(tick_plan), ctypes.addressof(prog_plan),
                                         ctypes.addressof(out))
        super().__init__(out.value)


class _ProgramPlan(ctypes.Structure):
    """``struct em_program::ProgramPlan`` of ``csrc/em_boundary.cuh``."""

    _fields_ = [
        *((name, _P) for name in (
            "stats", "hood_e", "lane", "ctl", "em_mu", "em_sigma", "mu", "sigma", "ring",
            "total_hist", "sigma_min", "reseed_mu", "reseed_sigma", "mu0", "sigma0", "labels0",
            "labels", "votes", "result_host")),
        ("em_cond", ctypes.c_ulonglong),
        ("map_cond", ctypes.c_ulonglong),
        *((name, _I) for name in (
            "batch", "n_hoods", "n_vertices", "n_labels", "window", "max_em_iters",
            "max_map_iters", "conditional", "stats_at_zero")),
        ("conv_tol", ctypes.c_float),
    ]


class _TickCtlPlan(ctypes.Structure):
    """``struct em_control::TickCtlPlan`` of ``csrc/em_control.cuh``."""

    _fields_ = [
        *((name, _P) for name in ("lane", "ctl", "tick", "in_host", "out_host")),
        ("loop_cond", ctypes.c_ulonglong),
        ("stop_cond", ctypes.c_ulonglong),
        *((name, _I) for name in ("batch", "max_map_iters", "conditional")),
    ]


#: The kernels a program's node launches (``NodeKind`` of ``csrc/em_tick.cu``).
NODES = {"program_init": 0, "boundary": 1, "tick_lanes": 2, "tick_init": 3, "tick_stops": 4,
         "tick_tail": 5, "tick_publish": 6, "map_ctl": 7}
#: Conditional node types of :meth:`ProgramBuilder.conditional`.
WHILE, IF = 0, 1
#: Out-words of a tick: per lane (``em_control::kOutPerLane``), and after
#: the lanes (``kTickOut``, named by ``ref.TICK_OUT``).
TICK_OUT_PER_LANE = 5
TICK_OUT = ref.TICK_OUT
#: Result words of a solve's program after the lanes' (``em_program::kResultWords``).
RESULT_OUT = ("steps", "ticks", "boundaries", "seg_add", "seg_ordered", "seg_min")


def program_plan(st: ref.BoundaryState, *, max_em_iters: int, max_map_iters: int,
                 conv_tol: float, stats_at_zero: bool = False, n_vertices: int = 0,
                 **pointers) -> "_ProgramPlan":
    """The boundary kernel's plan over ``st``'s tensors (a lane axis),
    and ``pointers`` for its other fields (``mu0``, ``result_host``, ...)."""
    g = _ProgramPlan()
    for name in ref.BoundaryState._fields:
        setattr(g, name, getattr(st, name).data_ptr())
    for name, value in pointers.items():
        setattr(g, name, value)
    g.batch, g.n_labels = int(st.em_mu.shape[0]), int(st.em_mu.shape[1])
    g.n_hoods, g.n_vertices = int(st.hood_e.shape[1]), n_vertices
    g.window = int(st.total_hist.shape[1]) - 1
    g.max_em_iters, g.max_map_iters, g.conv_tol = max_em_iters, max_map_iters, conv_tol
    g.stats_at_zero = int(stats_at_zero)
    return g


class ProgramBuilder:
    """A program assembled node by node (``repro_prog_*``): graph 0 is the
    top graph, each conditional node adds its body's graph; every node
    goes after the one added before it in its graph.  Used as a context
    manager: :meth:`finish` inside it, or the builder is freed on the way
    out."""

    def __init__(self, device: torch.device):
        out = ctypes.c_void_p()
        _entry("repro_prog_new")(device.index, ctypes.addressof(out))
        self._b, self._keep = out.value, []

    def __enter__(self) -> "ProgramBuilder":
        return self

    def __exit__(self, *exc) -> None:
        if self._b:
            _entry("repro_prog_abandon")(self._b)
            self._b = None

    def handle(self, graph: int, default: int = 0, assign: bool = False) -> int:
        """A conditional handle of ``graph`` (``assign``: ``default`` at every launch)."""
        h = ctypes.c_ulonglong(0)
        _entry("repro_prog_handle")(self._b, graph, default, int(assign), ctypes.addressof(h))
        return h.value

    def conditional(self, graph: int, handle: int, kind: int) -> int:
        """A ``WHILE`` or ``IF`` node on ``handle``; returns its body's graph."""
        body = ctypes.c_int(0)
        _entry("repro_prog_conditional")(self._b, graph, handle, kind, ctypes.addressof(body))
        return body.value

    def child(self, graph: int, ops: "CapturedOps") -> None:
        """``ops``'s captured graph as a child node (kept alive by the program)."""
        _entry("repro_prog_child")(self._b, graph, ops.graph_ptr)
        self._keep.append(ops)

    def node(self, graph: int, kind: str, plan: ctypes.Structure) -> None:
        """One launch of kernel ``kind`` (:data:`NODES`) with ``plan``'s values."""
        _entry("repro_prog_node")(self._b, graph, NODES[kind], ctypes.addressof(plan))

    def finish(self) -> Program:
        out, b = ctypes.c_void_p(), self._b
        self._b = None
        _entry("repro_prog_finish")(b, ctypes.addressof(out))
        return Program(out.value, self._keep)


class ControlKernels:
    """The control kernels launched one by one outside any graph (no
    handle), on the CUDA words ``lane`` (8, B), ``ctl`` and ``tick``, with
    mapped in- and out-words allocated once: the kernels' checks against
    their plain versions in ``ref``, and their timing.  ``in_words`` are
    the host's in-words (1 + 3 B ints)."""

    def __init__(self, lane: torch.Tensor, ctl: torch.Tensor, tick: torch.Tensor, in_words,
                 max_map_iters: int):
        b = int(lane.shape[1])
        self.device = lane.device
        self._in = _HostWord(1 + 3 * b)
        (ctypes.c_int * (1 + 3 * b)).from_address(self._in.host)[:] = list(in_words)
        self._out = _ResultWords(TICK_OUT_PER_LANE * b + len(TICK_OUT))
        c = self._plan = _TickCtlPlan()
        c.lane, c.ctl, c.tick = lane.data_ptr(), ctl.data_ptr(), tick.data_ptr()
        c.in_host, c.out_host = self._in.device, self._out.words.device
        c.batch, c.max_map_iters, c.conditional = b, max_map_iters, 0
        self._addr = ctypes.addressof(c)
        self._launch = _entry("repro_prog_launch_kind")

    def launch(self, kinds) -> None:
        """One launch of each kernel of ``kinds`` (of ``tick_init``,
        ``tick_stops``, ``tick_tail``, ``tick_publish``, ``map_ctl``), in
        that order, on the current stream of the words' device (a graph's
        capture stream too); no wait."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for kind in kinds:
            self._launch(NODES[kind], self._addr, stream)

    def read(self) -> list:
        """Wait for the current stream, and read the out-words
        ``tick_publish`` last wrote (5 B + ``len(TICK_OUT)`` ints)."""
        return self._out.read(torch.cuda.current_stream(self.device).cuda_stream)


class CapturedOps:
    """PyTorch operations captured as a CUDA graph that is never replayed by
    itself: programs take it as a child graph node
    (:meth:`ProgramBuilder.child`).  ``fn`` runs once on a side stream (its
    libraries and kernels loaded), then once under capture into a
    ``torch.cuda.CUDAGraph(keep_graph=True)``, whose private memory pool
    holds the temporaries for as long as this object lives; ``fn`` must
    write its results into tensors allocated before (fixed addresses), do
    no host synchronisation and use one stream.  Its ``segment_reduce``
    launches count themselves on the device, into the three int32 words at
    ``count_words`` (``segment_reduce.counting_on_device``), in the warm-up
    and on every replay: the program zeroes them at its start and publishes
    them with its result."""

    def __init__(self, fn, device: torch.device, count_words: int):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with _segment_reduce.counting_on_device(count_words):
            with torch.cuda.stream(side):
                fn()
            cur.wait_stream(side)
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.graph, stream=side):
                fn()
        self.graph_ptr = self.graph.raw_cuda_graph()


class _ResultWords:
    """``n`` mapped result words and their read: one wait on a stream, no copy."""

    def __init__(self, n: int):
        self.n, self.words = n, _HostWord(n)
        self.view = (ctypes.c_int * n).from_address(self.words.host)
        self._out = (ctypes.c_int * n)()
        self._wait = _entry("repro_em_program_wait")

    def read(self, stream: int) -> list:
        self._wait(stream, self.words.host, self.n, ctypes.addressof(self._out))
        return list(self._out)


class TickProgram:
    """A served pool's tick as one CUDA graph (``csrc/em_control.cuh``):

        tick_init -> WHILE { step -> tick_stops -> IF { [M-step] -> boundary }
                             -> tick_tail } -> tick_publish

    ``step`` and ``mstep`` append the pool's step (the tick's pool entry, or
    a mode's captured flat step) and, for the modes, the captured M-step
    into a body of the builder: ``step(builder, graph)``.  The pool's words
    and buffers are ``ws``'s: ``lane``, ``ctl``, ``tick`` and the boundary's
    (``ws.boundary_state()``).  ``tick_iters`` and each lane's EM counters
    and status go in through mapped in-words before the launch (the host's
    ``TickState`` lists), the results come back through mapped out-words:
    one graph launch, one wait.  Built once per pool and EM limit: every
    tick size replays it."""

    def __init__(self, ws, step, mstep, *, max_em_iters: int, conv_tol: float,
                 stats_at_zero: bool = False):
        b = ws.batch
        self.batch, self.max_em_iters = b, max_em_iters
        self._in = _HostWord(1 + 3 * b)
        self._in_view = (ctypes.c_int * (1 + 3 * b)).from_address(self._in.host)
        self._out = _ResultWords(TICK_OUT_PER_LANE * b + len(TICK_OUT))
        c = self._ctl = _TickCtlPlan()
        c.lane, c.ctl, c.tick = ws.lane.data_ptr(), ws.ctl.data_ptr(), ws.tick.data_ptr()
        c.in_host, c.out_host = self._in.device, self._out.words.device
        c.batch, c.max_map_iters, c.conditional = b, ws.max_map_iters, 1
        g = program_plan(ws.boundary_state(), max_em_iters=max_em_iters,
                         max_map_iters=ws.max_map_iters, conv_tol=conv_tol,
                         stats_at_zero=stats_at_zero, n_vertices=ws.shape.n_vertices)
        with ProgramBuilder(ws.device) as pb:
            c.loop_cond = pb.handle(0)
            pb.node(0, "tick_init", c)
            body = pb.conditional(0, c.loop_cond, WHILE)
            c.stop_cond = pb.handle(body)
            step(pb, body)
            pb.node(body, "tick_stops", c)
            stopped = pb.conditional(body, c.stop_cond, IF)
            if mstep is not None:
                mstep(pb, stopped)
            pb.node(stopped, "boundary", g)
            pb.node(body, "tick_tail", c)
            pb.node(0, "tick_publish", c)
            self._program = pb.finish()

    def launch(self, stream: int, tick_iters: int, em_iters, map_iters, status) -> None:
        """Write the in-words and launch the tick on ``stream``."""
        global launches_graph
        b, w = self.batch, self._in_view
        w[0] = tick_iters
        w[1:1 + b], w[1 + b:1 + 2 * b], w[1 + 2 * b:1 + 3 * b] = em_iters, map_iters, status
        self._program.launch(stream)
        launches_graph += 1

    def result(self, stream: int) -> dict:
        """Wait for the tick and read its out-words: per lane ``(em_iters,
        map_iters, status, map_i, active)`` under ``"lanes"``, and
        :data:`TICK_OUT`: the micro-steps, the step kernel's launches (0 for
        a mode's captured step), the boundary's launches, the micro-steps in
        which some lane stopped, the control kernels' launches and the
        captured ``segment_reduce`` launches, every launch as the kernel
        counted itself on the device.  The control kernels' and
        ``segment_reduce``'s are added to this process's counts."""
        words, b, n = self._out.read(stream), self.batch, TICK_OUT_PER_LANE
        out = dict(zip(TICK_OUT, words[n * b:]))
        out["lanes"] = [tuple(words[n * j:n * j + n]) for j in range(b)]
        for kind in ("tick_init", "tick_stops", "tick_publish"):
            launches_control[kind] += out[kind]
        launches_control["tick_tail"] += out["steps"]
        _segment_reduce.count_device(out["seg_add"], out["seg_ordered"], out["seg_min"])
        return out


class ModesProgram:
    """A solve or stack of the modes ``static`` and ``faithful`` as one CUDA
    graph, the static-pallas solve's program with the modes' step:

        program_init -> WHILE(em) { WHILE(map) { step -> map_ctl }
                                    -> M-step -> boundary }

    ``step`` and ``mstep`` are :class:`CapturedOps` of the workspace's flat
    MAP step (each lane's gate and cap from its own MAP counter) and of its
    M-step; ``st`` the boundary's tensors, ``lane``/``ctl`` its words,
    ``mu0``/``sigma0`` the solve's start (the labels are copied in by the
    workspace's ``start``).  One launch, one wait for the 3 B +
    ``len(RESULT_OUT)`` result words (the boundary kernel's)."""

    def __init__(self, device: torch.device, st: ref.BoundaryState, mu0, sigma0, step, mstep, *,
                 max_em_iters: int, max_map_iters: int, conv_tol: float, n_vertices: int):
        b = int(st.em_mu.shape[0])
        self.batch = b
        self._out = _ResultWords(3 * b + len(RESULT_OUT))
        g = program_plan(st, max_em_iters=max_em_iters, max_map_iters=max_map_iters,
                         conv_tol=conv_tol, stats_at_zero=True, n_vertices=n_vertices,
                         mu0=mu0.data_ptr(), sigma0=sigma0.data_ptr(),
                         result_host=self._out.words.device)
        c = _TickCtlPlan()
        c.lane, c.ctl, c.batch, c.max_map_iters = st.lane.data_ptr(), st.ctl.data_ptr(), b, max_map_iters
        with ProgramBuilder(device) as pb:
            g.em_cond, g.conditional = (pb.handle(0), 1) if max_em_iters > 0 else (0, 0)
            pb.node(0, "program_init", g)
            if max_em_iters > 0:
                outer = pb.conditional(0, g.em_cond, WHILE)
                if max_map_iters > 0:
                    g.map_cond = c.loop_cond = pb.handle(outer, 1, assign=True)
                    c.conditional = 1
                    inner = pb.conditional(outer, g.map_cond, WHILE)
                    pb.child(inner, step)
                    pb.node(inner, "map_ctl", c)
                pb.child(outer, mstep)
                g.conditional = 1 | (2 if max_map_iters > 0 else 0)
                pb.node(outer, "boundary", g)
            self._program = pb.finish()
        self._keep = (step, mstep)

    def launch(self, stream: int) -> None:
        global launches_graph
        self._program.launch(stream)
        launches_graph += 1

    def result(self, stream: int) -> tuple:
        """One wait: each lane's EM iterations, MAP iterations and status,
        the lockstep MAP iterations, the flat steps (``map_ctl``'s launches)
        and the boundaries, each launch counted by its kernel on the device;
        ``map_ctl``'s and the captured ``segment_reduce`` launches are added
        to this process's counts."""
        words, b = self._out.read(stream), self.batch
        em, maps, status = words[0:3 * b:3], words[1:3 * b:3], words[2:3 * b:3]
        out = dict(zip(RESULT_OUT, words[3 * b:]))
        launches_control["map_ctl"] += out["ticks"]
        _segment_reduce.count_device(out["seg_add"], out["seg_ordered"], out["seg_min"])
        return em, maps, status, out["steps"], out["ticks"], out["boundaries"]


class _Lanes:
    """The buffers of ``batch`` lanes of one bucket on the card, the one
    layout both tick workspaces keep (a single problem is one lane): the
    solve's inputs, owned and filled in by ``start`` (so every kernel, and
    the program's graph, reads fixed addresses), the MAP iteration's state
    (two label and two vote buffers per lane swapped by its parity word,
    the history ring, ``hood_e``, the M-step sums, the parameters), the
    EM boundary's (the EM-level parameters, the total-energy ring), the
    lane block and the program's words (``ref.LANE_WORDS``,
    ``ref.CTL_WORDS``), the tickets, and the mapped result words.

    Built with the EM limits (``max_em_iters`` not None) it compiles the
    program (:class:`SolveGraph`) from these buffers; :meth:`run_program`
    replays it (one graph launch) and :meth:`program_result` reads the
    solve's counters (one wait, no copy)."""

    max_em_iters = None

    def _alloc(self, shape: TickShape, batch: int, dev, precision: str, conv_tol: float,
               window: int, max_em_iters, max_map_iters) -> None:
        self.capacity, nh, nv, k = shape
        f32, i32 = torch.float32, torch.int32
        z = lambda *s, dtype=f32: torch.zeros((batch, *s), dtype=dtype, device=dev)  # noqa: E731
        one = lambda *s: torch.ones((batch, *s), dtype=f32, device=dev)  # noqa: E731
        self._inputs = {
            "y": z(self.capacity), "w": z(self.capacity), "nall": z(self.capacity),
            "valid": z(self.capacity), "vertex": z(self.capacity, dtype=i32),
            "offsets": z(nh + 1, dtype=i32), "region_mean": z(nv), "region_weight": z(nv),
            "beta": z(), "sigma_min": z(), "reseed_mu": z(k), "reseed_sigma": one(),
            "mu0": z(k), "sigma0": one(k), "labels0": z(nv, dtype=i32),
        }
        self._labels = z(2, nv, dtype=i32)
        self._votes = z(2, k, nv)
        self._ring = z(window + 1, nh)
        self._hood_e = z(nh)
        self._stats = z(3, k)
        self._mu, self._sigma = z(k), one(k)
        self._em_mu, self._em_sigma = z(k), one(k)
        self._total_hist = z(window + 1)
        self._lane = torch.zeros((len(ref.LANE_WORDS), batch), dtype=i32, device=dev)
        self._ctl = torch.zeros((len(ref.CTL_WORDS),), dtype=i32, device=dev)
        self._sync = z(2, dtype=i32)
        self._lane_ix = torch.arange(batch, device=dev)
        self._window, self._conv_tol = window, conv_tol
        self._graph = None
        self._stream = None
        if max_em_iters is not None:
            self._build_program(batch, precision, max_em_iters, max_map_iters)

    def _tick_plan(self, batch: int, precision: str, max_map_iters: int) -> _TickBatchPlan:
        """The lane entry's plan over these buffers (the host-stepped
        stack's, or with the MAP counters the program's)."""
        p = _TickBatchPlan()
        for name, t in self._inputs.items():
            if hasattr(p, name):
                setattr(p, name, t.data_ptr())
        p.mu, p.sigma = self._mu.data_ptr(), self._sigma.data_ptr()
        p.labels, p.votes, p.ring = self._labels.data_ptr(), self._votes.data_ptr(), self._ring.data_ptr()
        p.hood_e, p.stats, p.sync = self._hood_e.data_ptr(), self._stats.data_ptr(), self._sync.data_ptr()
        lane = self._lane
        p.flag_dev, p.parity, p.active = (lane[i].data_ptr() for i in (ref.FLAG, ref.PARITY, ref.ACTIVE))
        p.batch, p.capacity, p.hist_rows = batch, self.capacity, self._window + 1
        p.n_hoods, p.n_vertices, p.n_labels = self.n_hoods, self.n_vertices, self.n_labels
        p.bf16, p.device, p.conv_tol = int(precision == "bf16"), self.device.index, self._conv_tol
        p.max_map_iters = max_map_iters
        return p

    def _build_program(self, batch: int, precision: str, max_em_iters: int, max_map_iters: int):
        if max_em_iters < 0 or max_map_iters < 0:
            raise ValueError(f"the EM limits must be >= 0, got {max_em_iters} and {max_map_iters}")
        self.max_em_iters, self.max_map_iters = max_em_iters, max_map_iters
        self._result = _ResultWords(3 * batch + len(RESULT_OUT))
        t = self._gplan = self._tick_plan(batch, precision, max_map_iters)
        t.map_i = self._lane[ref.MAP_I].data_ptr()
        t.map_live = self._ctl[ref.MAP_LIVE].data_ptr()
        t.launch_count = self._ctl[ref.TICK_LAUNCHES].data_ptr()
        inp = self._inputs
        st = ref.BoundaryState(self._stats, self._hood_e, self._lane, self._ctl, self._em_mu,
                               self._em_sigma, self._mu, self._sigma, self._ring, self._total_hist,
                               inp["sigma_min"], inp["reseed_mu"], inp["reseed_sigma"])
        g = self._pplan = program_plan(
            st, max_em_iters=max_em_iters, max_map_iters=max_map_iters, conv_tol=self._conv_tol,
            n_vertices=self.n_vertices, **{n: inp[n].data_ptr() for n in ("mu0", "sigma0", "labels0")},
            labels=self._labels.data_ptr(), votes=self._votes.data_ptr(),
            result_host=self._result.words.device)
        with torch.cuda.device(self.device):
            self._graph = SolveGraph(t, g)

    def _bind(self, require, lead: tuple, hoods, model, y, w, nall_e, valid, labels0,
              mu0=None, sigma0=None) -> None:
        """The operand checks, then one copy of the solve's arrays into the
        workspace's own (on the current stream)."""
        dev, f32, k = self.device, torch.float32, self.n_labels
        _check_problem(require, self.shape, hoods, model, lead, dev)
        for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("valid", valid)):
            require(t, name, f32, lead + (self.capacity,), dev)
        require(labels0, "labels0", torch.int32, lead + (self.n_vertices,), dev)
        srcs = {"y": y, "w": w, "nall": nall_e, "valid": valid, "vertex": hoods.vertex,
                "offsets": hoods.offsets, "region_mean": model.region_mean,
                "region_weight": model.region_weight, "beta": model.beta,
                "sigma_min": model.sigma_min, "reseed_mu": model.reseed_mu,
                "reseed_sigma": model.reseed_sigma, "labels0": labels0}
        for name in ("beta", "sigma_min", "reseed_sigma"):
            require(srcs[name].reshape(lead), name, f32, lead, dev)
        require(model.reseed_mu, "reseed_mu", f32, lead + (k,), dev)
        if mu0 is not None:
            require(mu0, "mu0", f32, lead + (k,), dev)
            require(sigma0, "sigma0", f32, lead + (k,), dev)
            srcs.update(mu0=mu0, sigma0=sigma0)
        dst = [self._inputs[n] for n in srcs]
        torch._foreach_copy_(dst, [t.reshape(d.shape) for t, d in zip(srcs.values(), dst)])

    def run_program(self, marks=None) -> None:
        """The solve bound by ``start`` (with ``mu0`` and ``sigma0``): one
        launch of the program on the current stream.  ``marks`` is the
        plain program's census hook; the graph's loops are on the card."""
        if self._graph is None:
            raise ValueError("this workspace was built without the EM limits: it has no program")
        self.launch_program()

    def launch_program(self) -> None:
        global launches_graph
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        self._graph.launch(self._stream)
        launches_graph += 1

    def program_result(self) -> tuple:
        """Wait for the program and read the solve's counters from the
        mapped result words: each lane's EM iterations, MAP iterations and
        status, and the lockstep MAP iterations.  The launch counts take
        the graph's kernels as the kernels counted themselves on the device
        (``program_launches``: the tick's and the boundary's)."""
        global launches, launches_batched, launches_boundary
        words, n = self._result.read(self._stream), self._result.n
        b = (n - len(RESULT_OUT)) // 3
        em, maps, status = words[0:3 * b:3], words[1:3 * b:3], words[2:3 * b:3]
        steps, ticks, boundaries = words[3 * b:3 * b + 3]
        self.program_launches = {"tick": ticks, "em_boundary": boundaries}
        launches += ticks
        if self._batched:
            launches_batched += ticks
        launches_boundary += boundaries
        return em, maps, status, steps

    def program_views(self) -> tuple:
        """(B, ...) views of the program's outputs: labels (gathered by the
        parity words: a new tensor), the EM-level mu and sigma, the hood
        energies and the total-energy ring."""
        labels = self._labels[self._lane_ix, self._lane[ref.PARITY].long()]
        return labels, self._em_mu, self._em_sigma, self._hood_e, self._total_hist


class TickWorkspace(_Lanes):
    """The single-device EM driver's MAP-iteration state on the card, for
    one bucket: built from its shapes alone and reused by every solve of a
    problem of those shapes.

    Built once per (``ref.TickShape``, precision, device, EM limits): the
    buffers of one lane (:class:`_Lanes`: the solve's inputs, two label
    buffers and two vote fields, each step reading one and writing the
    other and zeroing the vote field it does not use, the (window + 1,
    n_hoods) history ring, ``hood_e``, the M-step sums, the words), a
    mapped pinned host word for the flag and, with the EM limits, the
    compiled EM program.  ``start`` checks the solve's operands and copies
    them in.

    The program (``em.run_em``): :meth:`start` with ``mu0`` and ``sigma0``,
    :meth:`run_program` (one graph launch: the tick's lane entry at B = 1
    with its controls from the device, the boundary kernel, their loops
    conditional nodes), :meth:`program_result` (one wait).

    Host-stepped (the per-launch checks, ``testing.host_loop``):
    :meth:`start` without ``mu0``, :meth:`begin_em` at each EM iteration,
    then per MAP iteration ``step(gate, cap)`` (one ``ctypes`` call, one
    launch of the single entry, its parity, head, gate and cap from the
    host) and :meth:`flag` (one wait; the bits are ``ref.FLAG_*``).
    ``labels``, ``hood_e`` and ``votes`` are views of the buffers after the
    last step, valid until the next; ``stats`` holds the M-step sums of the
    last launch that stopped a MAP loop.
    """

    #: The EM mode whose MAP iteration the workspace steps.
    mode = "static-pallas"
    _batched = False

    def __init__(self, shape: TickShape, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_em_iters=None,
                 max_map_iters: int = 10):
        dev = _check_shape("TickWorkspace", shape, precision, device)
        self.shape, self.device, self.precision = shape, dev, precision
        self.capacity, nh, nv, n_labels = shape
        self.n_hoods, self.n_vertices, self.n_labels = nh, nv, n_labels
        self._alloc(shape, 1, dev, precision, conv_tol, window, max_em_iters, max_map_iters)
        self.ring, self.hood_e, self.stats = self._ring[0], self._hood_e[0], self._stats[0]
        self._host = _HostWord()
        self._plan = p = _TickPlan()
        for name, t in self._inputs.items():
            if hasattr(p, name):
                setattr(p, name, t.data_ptr())
        p.mu, p.sigma = self._mu.data_ptr(), self._sigma.data_ptr()
        p.labels[0], p.labels[1] = self._labels[0, 0].data_ptr(), self._labels[0, 1].data_ptr()
        p.votes[0], p.votes[1] = self._votes[0, 0].data_ptr(), self._votes[0, 1].data_ptr()
        p.ring, p.hood_e, p.stats = self.ring.data_ptr(), self.hood_e.data_ptr(), self.stats.data_ptr()
        p.flag_dev, p.sync = self._lane[ref.FLAG].data_ptr(), self._sync.data_ptr()
        p.flag_host_dev, p.flag_host = self._host.device, self._host.host
        p.hist_rows, p.n_hoods, p.n_vertices, p.n_labels = window + 1, nh, nv, n_labels
        p.bf16, p.device, p.conv_tol = int(precision == "bf16"), dev.index, conv_tol
        self._addr = ctypes.addressof(p)
        self._step = _entry("repro_em_tick_step")
        self._wait = _entry("repro_em_tick_wait")
        self._flag = ctypes.c_int(0)
        self._flag_addr = ctypes.addressof(self._flag)
        self._rows = window + 1
        self.parity = 0  # labels[parity] holds the current labels, votes[parity] is zero
        self.head = 0    # ring row of the newest hood energies

    def start(self, hoods, model, y, w, nall_e, valid, labels0, mu0=None, sigma0=None) -> None:
        """Bind a solve: check its hoods' ``vertex`` and ``offsets``, its
        model's region arrays and scalars, its element arrays
        (``energy.StaticMapContext``) and initial labels, and copy them into
        the workspace's buffers.  With ``mu0`` and ``sigma0`` it is the
        program's solve; without, a host-stepped one, whose labels start in
        buffer 0.  Everything runs on the current stream."""
        self._bind(_require_ws, (), hoods, model, y, w, nall_e, valid, labels0, mu0, sigma0)
        self._plan.stream = torch.cuda.current_stream(self.device).cuda_stream
        if mu0 is None:
            self.parity = 0
            self._labels[0, 0].copy_(labels0)
            self._votes[0, 0].zero_()

    def begin_em(self, mu, sigma) -> None:
        """An EM iteration's parameters (``sigma`` already clamped at
        ``sigma_min``), copied in; empties the history ring."""
        for name, t in (("mu", mu), ("sigma", sigma)):
            _require_ws(t, name, torch.float32, (self.n_labels,), self.device)
        self._mu[0].copy_(mu)
        self._sigma[0].copy_(sigma)
        self.ring.zero_()
        self.head = 0

    def step(self, gate: bool, cap: bool = False) -> None:
        """One MAP iteration: one launch; ``gate`` opens the flag's
        converged bit (the driver's MAP iteration count passed WINDOW),
        ``cap`` says the MAP loop stops after it (its last iteration), so
        that it takes the M-step sums whatever its flag."""
        global launches
        self._step(self._addr, self.parity, self.head, int(gate), int(cap))
        launches += 1
        self.parity ^= 1
        self.head = (self.head - 1) % self._rows

    def flag(self) -> int:
        """Wait for the last step and return its flag word."""
        self._wait(self._addr, self._flag_addr)
        return self._flag.value

    @property
    def labels(self) -> torch.Tensor:
        return self._labels[0, self.parity]

    @property
    def votes(self) -> torch.Tensor:
        """The last step's votes (zeroed by the next step)."""
        return self._votes[0, self.parity ^ 1]


class BatchTickWorkspace(_Lanes):
    """The batched EM driver's MAP-iteration state on the card: the state of
    :class:`TickWorkspace` for each of ``batch`` lanes of one bucket, one
    launch per MAP iteration for every lane still running.

    Per lane the buffers are rows of stacked tensors (:class:`_Lanes`);
    each lane has its own ticket, flag word, parity word (flipped by the
    launch, so a lane that stops keeps its labels where they are) and
    active word (cleared by the launch that stops the lane's MAP loop).

    The program (``em.run_em_batched``): :meth:`start` with ``mu0`` and
    ``sigma0`` (B, K), :meth:`run_program` (one graph launch: per lockstep
    MAP iteration one launch of the tick's lane entry, each lane's ring
    head, gate and cap from its own MAP counter, and per EM iteration one
    launch of the boundary's lane form), :meth:`program_result` (one wait
    for every lane's counters).

    Host-stepped: :meth:`start` without ``mu0``, :meth:`begin_em` at each
    EM iteration with ``(B, K)`` parameters and the lanes that run it, then
    per MAP iteration ``step(gate, cap)`` (the ring's ``head`` shared: every
    running lane starts each EM iteration together) and :meth:`flags` (one
    wait, B words; a word is the last launch's only for a lane that ran in
    it).  ``labels``, ``votes``, ``hood_e``, ``ring`` and ``stats`` are the
    lanes' views as :class:`TickWorkspace` has them.
    """

    #: The EM mode whose MAP iteration the workspace steps.
    mode = "static-pallas"
    _batched = True

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_em_iters=None,
                 max_map_iters: int = 10):
        dev = _check_shape("BatchTickWorkspace", shape, precision, device)
        if batch < 1:
            raise ValueError(f"BatchTickWorkspace needs batch >= 1, got {batch}")
        self.shape, self.batch, self.device, self.precision = shape, batch, dev, precision
        self.capacity, nh, nv, n_labels = shape
        self.n_hoods, self.n_vertices, self.n_labels = nh, nv, n_labels
        self._alloc(shape, batch, dev, precision, conv_tol, window, max_em_iters, max_map_iters)
        self.ring, self.hood_e, self.stats = self._ring, self._hood_e, self._stats
        self._active_host = torch.zeros((batch,), dtype=torch.int32).pin_memory()
        self._host = _HostWord(batch)
        self._plan = p = self._tick_plan(batch, precision, 0)
        p.flag_host_dev, p.flag_host = self._host.device, self._host.host
        self._addr = ctypes.addressof(p)
        self._step = _entry("repro_em_tick_step_batched")
        self._wait = _entry("repro_em_tick_wait_batched")
        self._flags = (ctypes.c_int * batch)()
        self._flags_addr = ctypes.addressof(self._flags)
        self._rows = window + 1
        self.head = 0

    def start(self, hoods, model, y, w, nall_e, valid, labels0, mu0=None, sigma0=None) -> None:
        """Bind a stack's solve (every tensor with a leading lane axis of
        ``batch``): check it and copy it into the workspace's buffers.  With
        ``mu0`` and ``sigma0`` it is the program's solve; without, a
        host-stepped one: the labels go to each lane's current buffer and
        every lane is inactive until :meth:`begin_em`.  Everything runs on
        the current stream."""
        self._bind(_require_batch, (self.batch,), hoods, model, y, w, nall_e, valid, labels0,
                   mu0, sigma0)
        self._plan.stream = torch.cuda.current_stream(self.device).cuda_stream
        if mu0 is None:
            # Each lane keeps its parity from the last solve: the vote buffer
            # it points at was zeroed by that solve's last launch.
            self._lane[ref.ACTIVE].zero_()  # every lane inactive until begin_em
            self._labels[self._lane_ix, self._lane[ref.PARITY].long()] = labels0

    def begin_em(self, mu, sigma, active) -> None:
        """An EM iteration's ``(B, K)`` parameters (``sigma`` already
        clamped at ``sigma_min``), copied in, and the lanes that run it
        (``active``, B booleans on the host); empties the history rings."""
        for name, t in (("mu", mu), ("sigma", sigma)):
            _require_batch(t, name, torch.float32, (self.batch, self.n_labels), self.device)
        self._mu.copy_(mu)
        self._sigma.copy_(sigma)
        self._active_host.copy_(torch.as_tensor([bool(a) for a in active], dtype=torch.int32))
        self._lane[ref.ACTIVE].copy_(self._active_host, non_blocking=True)
        self.ring.zero_()
        self.head = 0

    def step(self, gate: bool, cap: bool = False) -> None:
        """One MAP iteration of every active lane: one launch (``gate`` and
        ``cap`` as in :meth:`TickWorkspace.step`)."""
        global launches, launches_batched
        self._step(self._addr, self.head, int(gate), int(cap))
        launches += 1
        launches_batched += 1
        self.head = (self.head - 1) % self._rows

    def flags(self) -> list:
        """Wait for the last step and return the B flag words."""
        self._wait(self._addr, self._flags_addr)
        return list(self._flags)

    @property
    def active(self) -> torch.Tensor:
        """The lanes' active words (1: the lane runs the next step)."""
        return self._lane[ref.ACTIVE]

    @property
    def labels(self) -> torch.Tensor:
        """(B, n_vertices): each lane's current labels."""
        return self._labels[self._lane_ix, self._lane[ref.PARITY].long()]

    @property
    def votes(self) -> torch.Tensor:
        """(B, K, n_vertices): each lane's last step's votes."""
        return self._votes[self._lane_ix, (self._lane[ref.PARITY] ^ 1).long()]


class PoolTickWorkspace:
    """The continuous-batching driver's slot pool on the card: B slots of
    one bucket, each holding one lane's inputs and MAP-iteration state, one
    launch per micro-step for every active lane, each at its own MAP
    iteration.

    Unlike :class:`BatchTickWorkspace` it owns the lanes' inputs (stacked
    ``y``, ``w``, ``nall``, ``valid``, ``vertex``, ``offsets``,
    ``region_mean``, ``region_weight``, ``beta``, ``mu``, ``sigma``) beside
    the state of each lane (two label and two vote buffers swapped by the
    lane's parity word, the ring, ``hood_e``, the M-step sums, the ticket,
    flag, parity, active and MAP-counter words), so a request is admitted
    into a slot with device copies and no other lane moves.  Built from
    the shapes alone; ``max_map_iters`` is the cap every lane's MAP loop
    stops at (the kernel's per-lane cap bit).

    :meth:`admit` writes one lane's rows (the lane stays inactive);
    :meth:`begin_lanes` starts an EM iteration of some lanes (their
    parameters, ring rows and MAP counters, their active words set);
    :meth:`retire` clears a slot's active word; :meth:`step` is one launch
    (lane b runs MAP iteration ``map_i[b] + 1`` with its ring head, gate
    and cap derived from it; a lane that stops takes its M-step sums and
    clears its active word); :meth:`flags` is one wait for the B flag words
    (a word is the last launch's only for a lane that ran in it).  Every
    slot write touches that slot's rows alone, issued on the pool's stream
    (the current stream when the pool was built), so no host buffer is
    shared between writes that a wait does not separate.  A slot keeps its
    parity word across admissions; :meth:`admit` zeroes both of its vote
    buffers, so the buffer its parity names is zero whatever the lane
    before it left.
    """

    #: The EM mode whose MAP iteration the workspace steps.
    mode = "static-pallas"
    #: Its tick runs as the compiled graph (``em._tick_program``).
    graph_tick = True

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_map_iters: int = 10,
                 max_em_iters=None):
        dev = _check_shape("PoolTickWorkspace", shape, precision, device)
        if batch < 1 or max_map_iters < 1:
            raise ValueError(f"PoolTickWorkspace needs batch >= 1 and max_map_iters >= 1, got "
                             f"{batch} and {max_map_iters}")
        self.shape, self.batch, self.device, self.precision = shape, batch, dev, precision
        self.max_map_iters = max_map_iters
        self.capacity, nh, nv, n_labels = shape
        self.n_hoods, self.n_vertices, self.n_labels = nh, nv, n_labels
        f32, i32 = torch.float32, torch.int32
        z = lambda *s, dtype=f32: torch.zeros((batch, *s), dtype=dtype, device=dev)  # noqa: E731
        self.y, self.w, self.nall, self.valid = (z(self.capacity) for _ in range(4))
        self.vertex = z(self.capacity, dtype=i32)
        self.offsets = z(nh + 1, dtype=i32)
        self.region_mean, self.region_weight = z(nv), z(nv)
        self.beta = z()
        self.mu, self.sigma = z(n_labels), torch.ones((batch, n_labels), dtype=f32, device=dev)
        self._labels = z(2, nv, dtype=i32)
        self._votes = z(2, n_labels, nv)
        self.ring = z(window + 1, nh)
        self.hood_e = z(nh)
        self.stats = z(3, n_labels)
        # The EM level of each lane (em.TickState's tensors are these) and the
        # model terms its boundary reads.
        self.em_mu, self.em_sigma = z(n_labels), torch.ones((batch, n_labels), dtype=f32, device=dev)
        self.total_hist = z(window + 1)
        self.sigma_min, self.reseed_sigma = torch.ones((batch,), dtype=f32, device=dev), torch.ones(
            (batch,), dtype=f32, device=dev)
        self.reseed_mu = z(n_labels)
        # The lane block (ref.LANE_WORDS: the tick's active, MAP-counter, flag
        # and parity words among them), the boundary's words and the tick's.
        self.lane = torch.zeros((len(ref.LANE_WORDS), batch), dtype=i32, device=dev)
        self.ctl = torch.zeros((len(ref.CTL_WORDS),), dtype=i32, device=dev)
        self.tick = torch.zeros((len(ref.TICK_WORDS),), dtype=i32, device=dev)
        self._conv_tol = conv_tol
        self._sync = z(2, dtype=i32)
        self._host = _HostWord(batch)
        self._lane_ix = torch.arange(batch, device=dev)
        self._stream = torch.cuda.current_stream(dev)
        self._plan = p = _TickBatchPlan()
        for name in ("y", "w", "nall", "valid", "vertex", "offsets", "region_mean",
                     "region_weight", "beta", "mu", "sigma", "ring", "hood_e", "stats"):
            setattr(p, name, getattr(self, name).data_ptr())
        p.labels, p.votes, p.sync = self._labels.data_ptr(), self._votes.data_ptr(), self._sync.data_ptr()
        p.flag_dev, p.parity, p.active, p.map_i = (
            self.lane[i].data_ptr() for i in (ref.FLAG, ref.PARITY, ref.ACTIVE, ref.MAP_I))
        p.flag_host_dev, p.flag_host = self._host.device, self._host.host
        p.stream = self._stream.cuda_stream
        p.batch, p.capacity, p.hist_rows = batch, self.capacity, window + 1
        p.n_hoods, p.n_vertices, p.n_labels = nh, nv, n_labels
        p.bf16, p.device, p.conv_tol = int(precision == "bf16"), dev.index, conv_tol
        p.max_map_iters = max_map_iters
        self._addr = ctypes.addressof(p)
        self._step = _entry("repro_em_tick_step_pool")
        self._wait = _entry("repro_em_tick_wait_batched")
        self._flags = (ctypes.c_int * batch)()
        self._flags_addr = ctypes.addressof(self._flags)
        self.owner = None  # a weak reference to the pool state (em.TickState) driving the slots
        self.program, self.max_em_iters = None, max_em_iters
        if max_em_iters is not None:
            # The pool's tick (TickProgram): its step one launch of the pool
            # entry, counting itself in ctl.
            t = self._tick_graph_plan = _TickBatchPlan.from_buffer_copy(p)
            t.flag_host_dev = None
            t.launch_count = self.ctl[ref.TICK_LAUNCHES].data_ptr()
            with torch.cuda.device(dev):
                self.program = TickProgram(self, lambda pb, g: pb.node(g, "tick_lanes", t), None,
                                           max_em_iters=max_em_iters, conv_tol=conv_tol)

    def boundary_state(self) -> ref.BoundaryState:
        """The boundary kernel's tensors over the pool (its lane form)."""
        return ref.BoundaryState(self.stats, self.hood_e, self.lane, self.ctl, self.em_mu,
                                 self.em_sigma, self.mu, self.sigma, self.ring, self.total_hist,
                                 self.sigma_min, self.reseed_mu, self.reseed_sigma)

    def launch_tick(self, tick_iters: int, em_iters, map_iters, status) -> None:
        """One tick of the compiled program on the pool's stream: its
        in-words written, one graph launch."""
        self.program.launch(self._stream.cuda_stream, tick_iters, em_iters, map_iters, status)

    def tick_result(self) -> dict:
        """Wait for the tick (one wait): :meth:`TickProgram.result`, with the
        launches the kernels counted of themselves added to this module's
        counts."""
        global launches, launches_pool, launches_boundary
        out = self.program.result(self._stream.cuda_stream)
        launches += out["ticks"]
        launches_pool += out["ticks"]
        launches_boundary += out["boundaries"]
        return out

    def _check_slot(self, slot: int) -> int:
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} is not one of the pool's {self.batch}")
        return slot

    def admit(self, slot: int, hoods, model, y, w, nall_e, valid, labels0) -> None:
        """Write one lane's inputs into ``slot`` (one problem of the bucket's
        shapes: its hoods' ``vertex`` and ``offsets``, its model's region
        arrays and ``beta``, its element arrays, its initial labels) and
        zero its vote buffers; the lane stays inactive until
        :meth:`begin_lanes`."""
        b = self._check_slot(slot)
        dev, f32 = self.device, torch.float32
        _check_problem(_require_pool, self.shape, hoods, model, (), dev)
        for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("valid", valid)):
            _require_pool(t, name, f32, (self.capacity,), dev)
        _require_pool(labels0, "labels0", torch.int32, (self.n_vertices,), dev)
        _require_pool(model.beta.reshape(()), "beta", f32, (), dev)
        with torch.cuda.stream(self._stream):
            self.lane[ref.ACTIVE, b] = 0
            for dst, src in ((self.y, y), (self.w, w), (self.nall, nall_e), (self.valid, valid),
                             (self.vertex, hoods.vertex), (self.offsets, hoods.offsets),
                             (self.region_mean, model.region_mean),
                             (self.region_weight, model.region_weight),
                             (self.beta, model.beta.reshape(()))):
                dst[b].copy_(src)
            self._labels[b].copy_(labels0.expand(2, self.n_vertices))
            self._votes[b].zero_()
            self.lane[ref.MAP_I, b] = 0

    def begin_lanes(self, slots, mu, sigma) -> None:
        """Start an EM iteration of the lanes in ``slots``: their ``(n, K)``
        parameters (``sigma`` already clamped at ``sigma_min``), their ring
        rows and MAP counters zeroed, their active words set."""
        n = len(slots)
        for t, name in ((mu, "mu"), (sigma, "sigma")):
            _require_pool(t, name, torch.float32, (n, self.n_labels), self.device)
        for b in slots:
            self._check_slot(b)
        with torch.cuda.stream(self._stream):
            idx = torch.as_tensor(list(slots), dtype=torch.long).to(self.device)
            self.mu.index_copy_(0, idx, mu)
            self.sigma.index_copy_(0, idx, sigma)
            self.ring.index_fill_(0, idx, 0.0)
            self.lane[ref.MAP_I].index_fill_(0, idx, 0)
            self.lane[ref.ACTIVE].index_fill_(0, idx, 1)

    def retire(self, slot: int) -> None:
        """Clear ``slot``'s active word: the lane runs no further launch."""
        b = self._check_slot(slot)
        with torch.cuda.stream(self._stream):
            self.lane[ref.ACTIVE, b] = 0

    def step(self) -> None:
        """One MAP iteration of every active lane, each its own: one launch."""
        global launches, launches_pool
        self._step(self._addr)
        launches += 1
        launches_pool += 1

    def flags(self) -> list:
        """Wait for the last step and return the B flag words."""
        self._wait(self._addr, self._flags_addr)
        return list(self._flags)

    @property
    def active(self) -> torch.Tensor:
        """The lanes' active words (1: the lane runs the next step)."""
        return self.lane[ref.ACTIVE]

    @property
    def map_i(self) -> torch.Tensor:
        """The lanes' MAP counters: iterations of the current MAP loop."""
        return self.lane[ref.MAP_I]

    @property
    def labels(self) -> torch.Tensor:
        """(B, n_vertices): each lane's current labels."""
        return self._labels[self._lane_ix, self.lane[ref.PARITY].long()]

    @property
    def votes(self) -> torch.Tensor:
        """(B, K, n_vertices): each lane's last step's votes."""
        return self._votes[self._lane_ix, (self.lane[ref.PARITY] ^ 1).long()]
