"""CUDA MAP step: ``csrc/map_step.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.map_step.fused_map_step_pallas``: the K
label energies, the per-element min/argmin, the per-hood energy sums and
the (label, vertex) votes of the sharded static-pallas route.  Two entry
points:

* :class:`MapStepWorkspace`, the sharded EM driver's: built once per
  (partition, rank, K) with every operand check, it runs one MAP
  iteration per :meth:`~MapStepWorkspace.step` (one ``ctypes`` call, one
  launch: the previous step's labels, history ring and flag tests, this
  rank's label counts over whole hood runs, energies, hood sums and votes)
  into a buffer that one all-reduce covers, and reads the flag word with
  one wait in :meth:`~MapStepWorkspace.flag`; the launch that stops a MAP
  loop also sums the M-step's per-label terms into ``stats``.  Its hood
  sums add this rank's elements in element order (``csrc/plainsum.cuh``)
  and its M-step sums the vertices in vertex order, as
  ``ref.PlainMapStepWorkspace``, its plain version, does on the CPU.
* :func:`fused_map_step_cuda`, with the JAX kernel's signature (per-element
  counts given, elements in any order), three launches per call.  Its hood
  sums are order-free (``csrc/segsum.cuh``): the same bits whatever the
  order of the elements.  ``ref.fused_map_step`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.em_tick import _check_labels, _HostWord

#: Launches of the kernel in this process (``ops.launch_counts``).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [
    _P, _P, _P, _P, _P, _P,        # y, w, cnt, nall, xf, valid
    _P, _P, _P, _P, _P,            # hood_id, vertex, mu, sigma, beta
    ctypes.c_longlong, _I, _I, _I,  # n, n_labels, n_hoods, n_vertices
    _P, _P, _P, _P,                # min_e, arg, hood_e, votes
    _P, _P,                        # workspace, stream
]
_WORKSPACE_FLOATS = 4  # per hood: the order-free hood sum's int64 sum, exponent key, flags
#: ``argtypes`` of the C entry points of ``csrc/map_step.cu``.
_SIGNATURES = {
    "repro_fused_map_step": _ARGTYPES,
    "repro_map_step_iteration": [_P, _I, _I, _I, _I, _I],  # plan, rot, head, gate, first, step
}

_require = functools.partial(_build.require, "fused_map_step_cuda")
_require_ws = functools.partial(_build.require, "MapStepWorkspace")


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    return _build.function("map_step", symbol, _SIGNATURES[symbol])


def fused_map_step_cuda(
    y: torch.Tensor,
    w: torch.Tensor,
    cnt_e: torch.Tensor,
    nall_e: torch.Tensor,
    xf: torch.Tensor,
    valid: torch.Tensor,
    hood_id: torch.Tensor,
    vertex: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    beta,
    *,
    n_hoods: int,
    n_vertices: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the step; returns ``(min_e, arg, hood_e, votes)`` like
    ``ref.fused_map_step``.

    Element arrays are contiguous (H,) float32 (int32 for ``hood_id`` and
    ``vertex``) in any order, ``cnt_e`` is (K, H) float32, ``mu`` and
    ``sigma`` (K,).  Lanes with ``valid == 0`` and ids outside
    ``[0, n_hoods)`` / ``[0, n_vertices)`` add to no sum.
    """
    global launches
    if not y.is_cuda:
        raise ValueError(f"fused_map_step_cuda needs CUDA tensors, got {y.device}")
    dev = y.device
    n_labels = int(mu.shape[0])
    h = int(y.shape[0])
    f32, i32 = torch.float32, torch.int32
    for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("xf", xf), ("valid", valid)):
        _require(t, name, f32, (h,), dev)
    _require(cnt_e, "cnt_e", f32, (n_labels, h), dev)
    _require(hood_id, "hood_id", i32, (h,), dev)
    _require(vertex, "vertex", i32, (h,), dev)
    _require(mu, "mu", f32, (n_labels,), dev)
    _require(sigma, "sigma", f32, (n_labels,), dev)
    beta_t = torch.as_tensor(beta, dtype=f32, device=dev).reshape(1).contiguous()

    min_e = torch.empty((h,), dtype=f32, device=dev)
    arg = torch.empty((h,), dtype=i32, device=dev)
    hood_e = torch.empty((n_hoods,), dtype=f32, device=dev)
    ws_len = _WORKSPACE_FLOATS * n_hoods
    zeroed = torch.zeros((ws_len + n_labels * n_vertices,), dtype=f32, device=dev)  # one memset
    votes = zeroed[ws_len:].view(n_labels, n_vertices)
    kernel = _entry("repro_fused_map_step")
    with torch.cuda.device(dev):
        kernel(
            y.data_ptr(), w.data_ptr(), cnt_e.data_ptr(), nall_e.data_ptr(),
            xf.data_ptr(), valid.data_ptr(), hood_id.data_ptr(), vertex.data_ptr(),
            mu.data_ptr(), sigma.data_ptr(), beta_t.data_ptr(),
            h, n_labels, n_hoods, n_vertices,
            min_e.data_ptr(), arg.data_ptr(), hood_e.data_ptr(), votes.data_ptr(),
            zeroed.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    launches += 1
    return min_e, arg, hood_e, votes


class _MapStepPlan(ctypes.Structure):
    """``struct MapStepPlan`` of ``csrc/map_step.cu``, field for field."""

    _fields_ = [
        *((name, _P) for name in (
            "y", "w", "nall", "valid", "vertex", "valid_all", "ranges", "mu", "sigma", "beta",
            "labels", "buffers", "ring", "sync", "flag_host", "region_mean", "region_weight",
            "stats", "stream")),
        ("base", ctypes.c_longlong),
        *((name, _I) for name in (
            "hist_rows", "n_hoods", "n_vertices", "n_labels", "n_local", "hood_lo", "device")),
        ("conv_tol", ctypes.c_float),
    ]


class _DeviceWord:
    """``__cuda_array_interface__`` of one int32 at a device address, for
    ``torch.as_tensor``."""

    def __init__(self, address: int):
        self.__cuda_array_interface__ = {
            "shape": (1,), "typestr": "<i4", "data": (address, False), "version": 3,
            "strides": None,
        }


def hood_runs(hoods, rank: int, n_shards: int):
    """The hood runs of rank ``rank``'s block of a partition of ``hoods``
    (``distributed.partition_hoods`` for ``n_shards``), from the host.

    Valid elements must be sorted by hood id, each id in ``[0, n_hoods)``.
    Returns ``(ranges, hood_lo, block)``: ``ranges`` an (n_local, 4) int32
    array, row ``j`` for hood ``hood_lo + j``, holding the hood's whole run
    in the partition (first and one past the last valid element) and its
    part in the block (the same, clipped to ``[rank * block, (rank + 1) *
    block)``); the local hoods are those from the block's first valid
    element's hood to its last one's.
    """
    cap = hoods.capacity
    if n_shards < 1 or cap % n_shards:
        raise ValueError(f"capacity {cap} does not split into {n_shards} blocks")
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside [0, {n_shards})")
    block = cap // n_shards
    valid = hoods.valid.cpu().numpy().astype(bool)
    hood_id = hoods.hood_id.cpu().numpy().astype(np.int64)
    at = np.nonzero(valid)[0]
    ids = hood_id[at]
    if ids.size and (ids.min() < 0 or ids.max() >= hoods.n_hoods):
        raise ValueError(f"a valid element's hood id is outside [0, {hoods.n_hoods})")
    if np.any(np.diff(ids) < 0):
        raise ValueError("the valid elements are not sorted by hood id")
    lo, hi = rank * block, (rank + 1) * block
    local = ids[(at >= lo) & (at < hi)]
    if local.size == 0:
        return np.zeros((0, 4), np.int32), 0, block
    hoods_here = np.arange(local[0], local[-1] + 1)
    first = np.searchsorted(ids, hoods_here, side="left")
    last = np.searchsorted(ids, hoods_here, side="right")
    run_begin = np.where(last > first, at[np.minimum(first, at.size - 1)], 0)
    run_end = np.where(last > first, at[np.maximum(last - 1, 0)] + 1, 0)
    ranges = np.stack([run_begin, run_end, np.clip(run_begin, lo, hi), np.clip(run_end, lo, hi)], 1)
    return ranges.astype(np.int32), int(local[0]), block


class MapStepWorkspace:
    """The sharded EM driver's MAP-iteration state on the card, for one rank
    of a partition, owned by a plan and reused by its solves.

    Built once per (partition, rank, K, device) from the partitioned
    ``hoods`` (``distributed.partition_hoods``: every rank holds all of its
    ``vertex``, ``hood_id`` and ``valid``): the local hoods' runs
    (:func:`hood_runs`, every check on them here), three ``[hood_e | votes]``
    buffers (each step writes one, the all-reduce sums it, the next step's
    head reads it, and the step after zeroes its votes), the labels, the
    (window + 1, n_hoods) history ring, the M-step sums, the kernel's
    ticket and a mapped pinned host word for the flag.

    A solve calls :meth:`start` once (this rank's element arrays and the
    initial labels), :meth:`begin_em` at each EM iteration, then per MAP
    iteration ``step(gate, step=...)`` (one ``ctypes`` call, one launch),
    the AND of the flag word across ranks where the driver wants it
    (``flag_word``, in place), :meth:`flag` (one wait) and the all-reduce
    of ``buffer``.  The launch whose flag word is not 0, or that takes no
    step, also writes the M-step sums of its head's labels to ``stats``
    (``(3, K)``: per label the sums of w, w y and w y y, each in vertex
    order).  ``labels`` are the labels the last head wrote (the
    caller's before any), ``hood_e`` and ``votes`` the all-reduced step it
    tested; views of the buffers, valid until the step after next.
    """

    def __init__(self, hoods, model, *, rank: int = 0, n_shards: int = 1,
                 conv_tol: float = 1.0e-4, window: int = 3):
        n_labels = model.n_labels
        _check_labels("MapStepWorkspace", n_labels)
        dev = hoods.vertex.device
        if dev.type != "cuda":
            raise ValueError(f"MapStepWorkspace needs CUDA tensors, got {dev}")
        nh, nv = hoods.n_hoods, hoods.n_regions + 1
        f32, i32 = torch.float32, torch.int32
        cap = hoods.capacity
        _require_ws(hoods.vertex, "vertex", i32, (cap,), dev)
        _require_ws(hoods.valid, "valid", torch.bool, (cap,), dev)
        _require_ws(model.region_mean, "region_mean", f32, (nv,), dev)
        _require_ws(model.region_weight, "region_weight", f32, (nv,), dev)
        ranges, self.hood_lo, self.block = hood_runs(hoods, rank, n_shards)
        self.rank, self.n_shards, self.base = rank, n_shards, rank * self.block
        self.device, self.n_labels, self.n_hoods, self.n_vertices = dev, n_labels, nh, nv
        self.n_local = int(ranges.shape[0])
        self._ranges = torch.from_numpy(ranges).to(dev)
        self._beta = model.beta.to(f32).reshape(1).contiguous()
        _require_ws(self._beta, "beta", f32, (1,), dev)
        self._labels = torch.zeros((nv,), dtype=i32, device=dev)
        self._buffers = torch.zeros((3, nh + n_labels * nv), dtype=f32, device=dev)
        self.ring = torch.zeros((window + 1, nh), dtype=f32, device=dev)
        self.stats = torch.zeros((3, n_labels), dtype=f32, device=dev)
        self._sync = torch.zeros((2,), dtype=i32, device=dev)  # ticket, accumulator
        self._host = _HostWord()
        #: The flag word as a CUDA tensor over the mapped host word: the
        #: kernel writes it, a collective may reduce it in place, and
        #: :meth:`flag` reads it with no copy.
        self.flag_word = torch.as_tensor(_DeviceWord(self._host.device), device=dev)
        self._keep = (hoods.vertex, hoods.valid, model.region_mean, model.region_weight)
        self._plan = p = _MapStepPlan()
        p.vertex, p.valid_all = hoods.vertex.data_ptr(), hoods.valid.data_ptr()
        p.ranges, p.beta = self._ranges.data_ptr(), self._beta.data_ptr()
        p.labels, p.buffers = self._labels.data_ptr(), self._buffers.data_ptr()
        p.ring, p.sync, p.flag_host = self.ring.data_ptr(), self._sync.data_ptr(), self._host.device
        p.region_mean, p.region_weight = model.region_mean.data_ptr(), model.region_weight.data_ptr()
        p.stats = self.stats.data_ptr()
        p.base = self.base
        p.hist_rows, p.n_hoods, p.n_vertices, p.n_labels = window + 1, nh, nv, n_labels
        p.n_local, p.hood_lo, p.device, p.conv_tol = self.n_local, self.hood_lo, dev.index or 0, conv_tol
        self._addr = ctypes.addressof(p)
        self._launch = _entry("repro_map_step_iteration")
        self._rows = window + 1
        self.rot = 0     # the buffer the next step writes
        self.head = 0    # ring row of the newest tested hood energies
        self.first = True

    def start(self, y, w, nall_e, valid, labels0) -> None:
        """Bind a solve's element arrays for this rank's block
        (``energy.StaticMapContext`` of the block) and copy its initial
        labels in; the MAP loop runs on the current stream."""
        dev, f32 = self.device, torch.float32
        for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("valid", valid)):
            _require_ws(t, name, f32, (self.block,), dev)
        _require_ws(labels0, "labels0", torch.int32, (self.n_vertices,), dev)
        self._elements = (y, w, nall_e, valid)
        p = self._plan
        p.y, p.w, p.nall, p.valid = (t.data_ptr() for t in self._elements)
        self._stream = torch.cuda.current_stream(dev)
        p.stream = self._stream.cuda_stream
        self._labels.copy_(labels0)

    def begin_em(self, mu, sigma) -> None:
        """An EM iteration's parameters (``sigma`` already clamped at
        ``sigma_min``); the next step is a MAP loop's first, which takes
        the labels as they are and tests nothing."""
        for name, t in (("mu", mu), ("sigma", sigma)):
            _require_ws(t, name, torch.float32, (self.n_labels,), self.device)
        self._params = (mu, sigma)
        self._plan.mu, self._plan.sigma = mu.data_ptr(), sigma.data_ptr()
        self.first = True
        self.head = 0

    def step(self, gate: bool, step: bool = True) -> None:
        """One launch: the head tests the last step (``gate`` opens the
        flag's converged bit), then, with ``step``, the next MAP step; if
        the flag word is not 0 or there is no step, the M-step sums."""
        global launches
        self._launch(self._addr, self.rot, self.head, int(gate), int(self.first), int(step))
        launches += 1
        if not self.first:
            self.head = (self.head - 1) % self._rows
        self.first = False
        self.rot = (self.rot + 1) % 3

    def flag(self) -> int:
        """Wait for the stream and return the flag word (``ref.FLAG_*``)."""
        self._stream.synchronize()
        return ctypes.c_int.from_address(self._host.host).value

    @property
    def buffer(self) -> torch.Tensor:
        """The last step's ``[hood_e | votes]``, for the all-reduce."""
        return self._buffers[(self.rot - 1) % 3]

    @property
    def labels(self) -> torch.Tensor:
        return self._labels

    @property
    def hood_e(self) -> torch.Tensor:
        """The hood sums the last head tested (all-reduced)."""
        return self._buffers[(self.rot - 2) % 3, : self.n_hoods]

    @property
    def votes(self) -> torch.Tensor:
        """The votes the last head took its labels from (all-reduced)."""
        return self._buffers[(self.rot - 2) % 3, self.n_hoods:].view(self.n_labels, self.n_vertices)
