"""CUDA EM tick: ``csrc/em_tick.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.em_tick.fused_em_tick_pallas``: the whole
tick of the static-pallas route (counts, energies, min/argmin, hood sums,
votes, labels, M-step sums, convergence flag) in one launch on the
current stream, for any K from 2 to ``MAX_LABELS``.  The kernel walks
each hood as a contiguous run of the (hood, vertex)-sorted element
arrays, so it takes ``offsets``, the (n_hoods + 1,) run boundaries
(``Hoods.offsets``).  Three entry points launch the same kernel body:

* :class:`TickWorkspace`, the EM driver's: built from a bucket's shapes
  alone (``ref.TickShape``: all buffers), bound to a solve's hoods, model
  and element arrays in :meth:`~TickWorkspace.start` (every operand check),
  it runs one MAP iteration per :meth:`~TickWorkspace.step` (one ``ctypes``
  call, one launch: the label gather, the history ring and the finiteness
  test are in the kernel) and reads the flag word with one wait in
  :meth:`~TickWorkspace.flag`.  ``ref.PlainTickWorkspace`` is its plain
  version.
* :class:`BatchTickWorkspace`, the batched driver's: the same for a stack
  of B problems padded to one bucket, one launch per MAP iteration for
  every lane still running (the kernel's lane axis), one wait for the B
  flag words.  ``ref.PlainBatchTickWorkspace`` is its plain version.
* :class:`PoolTickWorkspace`, the continuous-batching driver's
  (``em.run_em_ticked``): a pool of B slots that owns its lanes' inputs,
  whose lanes sit at different MAP iterations; one launch per micro-step
  runs every active lane's own next iteration (the kernel's per-lane MAP
  counters), one wait reads the B flag words.  Slot writes (``admit``,
  ``begin_lanes``, ``retire``) touch only that slot's rows.
  ``ref.PlainPoolTickWorkspace`` is its plain version.
* :func:`fused_em_tick_cuda`, with the JAX kernel's signature (``xf`` and
  ``hist`` given), allocating its outputs per call.  ``ref.fused_em_tick``
  is its plain version.

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

from repro_torch.kernels import _build
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
#: how many of them were the batched entry's and the pool entry's.
launches = 0
launches_batched = 0
launches_pool = 0

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


class TickWorkspace:
    """The single-device EM driver's MAP-iteration state on the card, for
    one bucket: built from its shapes alone and reused by every solve of a
    problem of those shapes.

    Built once per (``ref.TickShape``, precision, device): two label
    buffers and two vote fields (each step reads one and writes the other;
    the vote field it does not use it zeroes), the (window + 1, n_hoods)
    history ring, ``hood_e``, the M-step sums, the kernel's ticket and flag
    words, and a mapped pinned host word for the flag.  Every operand check
    runs in :meth:`start` (the solve's hoods, model and element arrays) and
    in :meth:`begin_em` (the parameters), never in the MAP loop.

    A solve calls :meth:`start` once, :meth:`begin_em` at each EM
    iteration, then per MAP iteration ``step(gate, cap)`` (one ``ctypes``
    call, one launch) and :meth:`flag` (one wait; the bits are
    ``ref.FLAG_*``).  ``labels``, ``hood_e`` and ``votes`` are views of the
    buffers after the last step, valid until the next; ``stats`` holds the
    M-step sums of the last launch that stopped a MAP loop.
    """

    def __init__(self, shape: TickShape, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3):
        dev = _check_shape("TickWorkspace", shape, precision, device)
        self.shape, self.device, self.precision = shape, dev, precision
        self.capacity, nh, nv, n_labels = shape
        self.n_hoods, self.n_vertices, self.n_labels = nh, nv, n_labels
        f32, i32 = torch.float32, torch.int32
        self._labels = torch.zeros((2, nv), dtype=i32, device=dev)
        self._votes = torch.zeros((2, n_labels, nv), dtype=f32, device=dev)
        self.ring = torch.zeros((window + 1, nh), dtype=f32, device=dev)
        self.hood_e = torch.zeros((nh,), dtype=f32, device=dev)
        self.stats = torch.zeros((3, n_labels), dtype=f32, device=dev)
        self._words = torch.zeros((3,), dtype=i32, device=dev)  # flag, ticket, accumulator
        self._host = _HostWord()
        self._plan = p = _TickPlan()
        p.labels[0], p.labels[1] = self._labels[0].data_ptr(), self._labels[1].data_ptr()
        p.votes[0], p.votes[1] = self._votes[0].data_ptr(), self._votes[1].data_ptr()
        p.ring, p.hood_e, p.stats = self.ring.data_ptr(), self.hood_e.data_ptr(), self.stats.data_ptr()
        p.flag_dev, p.sync = self._words.data_ptr(), self._words[1:].data_ptr()
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

    def start(self, hoods, model, y, w, nall_e, valid, labels0) -> None:
        """Bind a solve: its hoods' ``vertex`` and ``offsets``, its model's
        region arrays and ``beta``, its element arrays
        (``energy.StaticMapContext``); copy its initial labels in.  The MAP
        loop runs on the current stream."""
        dev, f32 = self.device, torch.float32
        _check_problem(_require_ws, self.shape, hoods, model, (), dev)
        for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("valid", valid)):
            _require_ws(t, name, f32, (self.capacity,), dev)
        _require_ws(labels0, "labels0", torch.int32, (self.n_vertices,), dev)
        beta = model.beta.to(f32).reshape(1).contiguous()
        _require_ws(beta, "beta", f32, (1,), dev)
        self._keep = (hoods.vertex, hoods.offsets, model.region_mean, model.region_weight, beta,
                      y, w, nall_e, valid)
        p = self._plan
        p.vertex, p.offsets = hoods.vertex.data_ptr(), hoods.offsets.data_ptr()
        p.region_mean, p.region_weight = model.region_mean.data_ptr(), model.region_weight.data_ptr()
        p.beta = beta.data_ptr()
        p.y, p.w, p.nall, p.valid = (t.data_ptr() for t in (y, w, nall_e, valid))
        p.stream = torch.cuda.current_stream(dev).cuda_stream
        self.labels.copy_(labels0)

    def begin_em(self, mu, sigma) -> None:
        """An EM iteration's parameters (``sigma`` already clamped at
        ``sigma_min``); empties the history ring."""
        for name, t in (("mu", mu), ("sigma", sigma)):
            _require_ws(t, name, torch.float32, (self.n_labels,), self.device)
        self._params = (mu, sigma)
        self._plan.mu, self._plan.sigma = mu.data_ptr(), sigma.data_ptr()
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
        return self._labels[self.parity]

    @property
    def votes(self) -> torch.Tensor:
        """The last step's votes (zeroed by the next step)."""
        return self._votes[self.parity ^ 1]


class BatchTickWorkspace:
    """The batched EM driver's MAP-iteration state on the card: the state of
    :class:`TickWorkspace` for each of ``batch`` lanes of one bucket, one
    launch per MAP iteration for every lane still running.

    Per lane the buffers are rows of stacked tensors; each lane has its own
    ticket, flag word, parity word (flipped by the launch, so a lane that
    stops keeps its labels where they are) and active word (set by
    :meth:`begin_em` for the lanes that run that EM iteration, cleared by
    the launch that stops a lane's MAP loop).  The ring's ``head`` is
    shared: every running lane starts each EM iteration together, and a
    stopped lane writes nothing.

    A solve calls :meth:`start` once with the stack (``Hoods`` and
    ``EnergyModel`` whose tensors carry a leading lane axis, the element
    arrays ``(B, capacity)``, the labels ``(B, n_vertices)``),
    :meth:`begin_em` at each EM iteration with ``(B, K)`` parameters and the
    lanes that run it, then per MAP iteration ``step(gate, cap)`` and
    :meth:`flags` (one wait, B words; a word is the last launch's only for
    a lane that ran in it).  ``labels``, ``votes``, ``hood_e``, ``ring``
    and ``stats`` are the lanes' views as :class:`TickWorkspace` has them.
    """

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3):
        dev = _check_shape("BatchTickWorkspace", shape, precision, device)
        if batch < 1:
            raise ValueError(f"BatchTickWorkspace needs batch >= 1, got {batch}")
        self.shape, self.batch, self.device, self.precision = shape, batch, dev, precision
        self.capacity, nh, nv, n_labels = shape
        self.n_hoods, self.n_vertices, self.n_labels = nh, nv, n_labels
        f32, i32 = torch.float32, torch.int32
        self._labels = torch.zeros((batch, 2, nv), dtype=i32, device=dev)
        self._votes = torch.zeros((batch, 2, n_labels, nv), dtype=f32, device=dev)
        self.ring = torch.zeros((batch, window + 1, nh), dtype=f32, device=dev)
        self.hood_e = torch.zeros((batch, nh), dtype=f32, device=dev)
        self.stats = torch.zeros((batch, 3, n_labels), dtype=f32, device=dev)
        # Per lane: flag, parity, active.
        self._words = torch.zeros((3, batch), dtype=i32, device=dev)
        self._sync = torch.zeros((batch, 2), dtype=i32, device=dev)
        self._active_host = torch.zeros((batch,), dtype=i32).pin_memory()
        self._host = _HostWord(batch)
        self._lane = torch.arange(batch, device=dev)
        self._plan = p = _TickBatchPlan()
        p.labels, p.votes, p.ring = self._labels.data_ptr(), self._votes.data_ptr(), self.ring.data_ptr()
        p.hood_e, p.stats, p.sync = self.hood_e.data_ptr(), self.stats.data_ptr(), self._sync.data_ptr()
        p.flag_dev, p.parity, p.active = (self._words[i].data_ptr() for i in range(3))
        p.flag_host_dev, p.flag_host = self._host.device, self._host.host
        p.batch, p.capacity, p.hist_rows = batch, self.capacity, window + 1
        p.n_hoods, p.n_vertices, p.n_labels = nh, nv, n_labels
        p.bf16, p.device, p.conv_tol = int(precision == "bf16"), dev.index, conv_tol
        self._addr = ctypes.addressof(p)
        self._step = _entry("repro_em_tick_step_batched")
        self._wait = _entry("repro_em_tick_wait_batched")
        self._flags = (ctypes.c_int * batch)()
        self._flags_addr = ctypes.addressof(self._flags)
        self._rows = window + 1
        self.head = 0

    def start(self, hoods, model, y, w, nall_e, valid, labels0) -> None:
        """Bind a stack's solve (every tensor with a leading lane axis of
        ``batch``) and copy its initial labels in; every lane inactive until
        :meth:`begin_em`.  The MAP loop runs on the current stream."""
        dev, f32, lead = self.device, torch.float32, (self.batch,)
        _check_problem(_require_batch, self.shape, hoods, model, lead, dev)
        for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("valid", valid)):
            _require_batch(t, name, f32, lead + (self.capacity,), dev)
        _require_batch(labels0, "labels0", torch.int32, lead + (self.n_vertices,), dev)
        beta = model.beta.to(f32).reshape(self.batch).contiguous()
        _require_batch(beta, "beta", f32, lead, dev)
        self._keep = (hoods.vertex, hoods.offsets, model.region_mean, model.region_weight, beta,
                      y, w, nall_e, valid)
        p = self._plan
        p.vertex, p.offsets = hoods.vertex.data_ptr(), hoods.offsets.data_ptr()
        p.region_mean, p.region_weight = model.region_mean.data_ptr(), model.region_weight.data_ptr()
        p.beta = beta.data_ptr()
        p.y, p.w, p.nall, p.valid = (t.data_ptr() for t in (y, w, nall_e, valid))
        p.stream = torch.cuda.current_stream(dev).cuda_stream
        # Each lane keeps its parity from the last solve: the vote buffer
        # it points at was zeroed by that solve's last launch.
        self._words[2].zero_()  # every lane inactive until begin_em
        self._labels[self._lane, self._words[1].long()] = labels0

    def begin_em(self, mu, sigma, active) -> None:
        """An EM iteration's ``(B, K)`` parameters (``sigma`` already
        clamped at ``sigma_min``) and the lanes that run it (``active``, B
        booleans on the host); empties the history rings."""
        for name, t in (("mu", mu), ("sigma", sigma)):
            _require_batch(t, name, torch.float32, (self.batch, self.n_labels), self.device)
        self._params = (mu, sigma)
        self._plan.mu, self._plan.sigma = mu.data_ptr(), sigma.data_ptr()
        self._active_host.copy_(torch.as_tensor([bool(a) for a in active], dtype=torch.int32))
        self._words[2].copy_(self._active_host, non_blocking=True)
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
        return self._words[2]

    @property
    def labels(self) -> torch.Tensor:
        """(B, n_vertices): each lane's current labels."""
        return self._labels[self._lane, self._words[1].long()]

    @property
    def votes(self) -> torch.Tensor:
        """(B, K, n_vertices): each lane's last step's votes."""
        return self._votes[self._lane, (self._words[1] ^ 1).long()]


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

    def __init__(self, shape: TickShape, batch: int, *, device, precision: str = "f32",
                 conv_tol: float = 1.0e-4, window: int = 3, max_map_iters: int = 10):
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
        # Per lane: flag, parity, active, MAP counter.
        self._words = torch.zeros((4, batch), dtype=i32, device=dev)
        self._sync = z(2, dtype=i32)
        self._host = _HostWord(batch)
        self._lane = torch.arange(batch, device=dev)
        self._stream = torch.cuda.current_stream(dev)
        self._plan = p = _TickBatchPlan()
        for name in ("y", "w", "nall", "valid", "vertex", "offsets", "region_mean",
                     "region_weight", "beta", "mu", "sigma", "ring", "hood_e", "stats"):
            setattr(p, name, getattr(self, name).data_ptr())
        p.labels, p.votes, p.sync = self._labels.data_ptr(), self._votes.data_ptr(), self._sync.data_ptr()
        p.flag_dev, p.parity, p.active, p.map_i = (self._words[i].data_ptr() for i in range(4))
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
            self._words[2, b] = 0
            for dst, src in ((self.y, y), (self.w, w), (self.nall, nall_e), (self.valid, valid),
                             (self.vertex, hoods.vertex), (self.offsets, hoods.offsets),
                             (self.region_mean, model.region_mean),
                             (self.region_weight, model.region_weight),
                             (self.beta, model.beta.reshape(()))):
                dst[b].copy_(src)
            self._labels[b].copy_(labels0.expand(2, self.n_vertices))
            self._votes[b].zero_()
            self._words[3, b] = 0

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
            self._words[3].index_fill_(0, idx, 0)
            self._words[2].index_fill_(0, idx, 1)

    def retire(self, slot: int) -> None:
        """Clear ``slot``'s active word: the lane runs no further launch."""
        b = self._check_slot(slot)
        with torch.cuda.stream(self._stream):
            self._words[2, b] = 0

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
        return self._words[2]

    @property
    def map_i(self) -> torch.Tensor:
        """The lanes' MAP counters: iterations of the current MAP loop."""
        return self._words[3]

    @property
    def labels(self) -> torch.Tensor:
        """(B, n_vertices): each lane's current labels."""
        return self._labels[self._lane, self._words[1].long()]

    @property
    def votes(self) -> torch.Tensor:
        """(B, K, n_vertices): each lane's last step's votes."""
        return self._votes[self._lane, (self._words[1] ^ 1).long()]
