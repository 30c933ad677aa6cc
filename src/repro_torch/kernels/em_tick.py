"""CUDA EM tick: ``csrc/em_tick.cu`` bound through ``ctypes``.

Counterpart of ``repro.kernels.em_tick.fused_em_tick_pallas``: the whole
tick of the static-pallas route (counts, energies, min/argmin, hood sums,
votes, labels, M-step sums, convergence flag) in one launch on the
current stream, for any K from 2 to ``MAX_LABELS``.  The kernel walks
each hood as a contiguous run of the (hood, vertex)-sorted element
arrays, so it takes ``offsets``, the (n_hoods + 1,) run boundaries
(``Hoods.offsets``).  Two entry points launch the same kernel:

* :class:`TickWorkspace`, the EM driver's: built once per plan (all
  buffers, every operand check), it runs one MAP iteration per
  :meth:`~TickWorkspace.step` (one ``ctypes`` call, one launch: the label
  gather, the history ring and the finiteness test are in the kernel) and
  reads the flag word with one wait in :meth:`~TickWorkspace.flag`.
  ``ref.fused_map_iteration`` is its plain version.
* :func:`fused_em_tick_cuda`, with the JAX kernel's signature (``xf`` and
  ``hist`` given), allocating its outputs per call.  ``ref.fused_em_tick``
  is its plain version.

The kernel adds each hood's energies in the plain versions' element
order at every K (``csrc/plainsum.cuh``), and from K = 9 on its M-step
sums too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import FLAG_CONVERGED, FLAG_DIVERGED  # noqa: F401 (bits of the flag word)

#: Most labels the kernel takes (5,282).  K = 2..8 are template
#: instantiations; any larger K runs a runtime-K variant whose hood pass
#: holds 3 K per-label terms and K counts for each of its 8 warps in shared
#: memory: 44 K bytes a block, within the 227 KB (232,448 bytes) a block
#: may use on an H100.
SMEM_PER_BLOCK = 232_448
MAX_LABELS = SMEM_PER_BLOCK // (4 * (3 + 8))

#: Launches of the kernel in this process (``ops.launch_counts``).
launches = 0

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


#: ``argtypes`` of the C entry points of ``csrc/em_tick.cu``.
_SIGNATURES = {
    "repro_fused_em_tick": _ARGTYPES,
    "repro_em_tick_step": [_P, _I, _I, _I],   # plan, parity, head, gate
    "repro_em_tick_wait": [_P, _P],           # plan, flag out
    "repro_em_tick_host_word": [_P, _P],      # host, device address out
}


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    return _build.function("em_tick", symbol, _SIGNATURES[symbol])


_require = functools.partial(_build.require, "fused_em_tick_cuda")
_require_ws = functools.partial(_build.require, "TickWorkspace")


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
    """A word of pinned host memory mapped into the card's address space,
    freed with the object."""

    host = None

    def __init__(self):
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _entry("repro_em_tick_host_word")(ctypes.addressof(host), ctypes.addressof(dev))
        self.host, self.device = host.value, dev.value
        self._free = _build.load("em_tick").repro_em_tick_free_host_word
        self._free.argtypes = [_P]

    def __del__(self):
        if self.host:
            self._free(self.host)
            self.host = None


class TickWorkspace:
    """The single-device EM driver's MAP-iteration state on the card, owned
    by a plan and reused by its solves.

    Built once per (hoods, K, precision, device): two label buffers and two
    vote fields (each step reads one and writes the other; the vote field
    it does not use it zeroes), the (window + 1, n_hoods) history ring,
    ``hood_e``, the M-step sums, the kernel's ticket and flag words, and a
    mapped pinned host word for the flag.  Every operand check runs here,
    in :meth:`start` (the solve's element arrays) and in :meth:`begin_em`
    (the parameters), never in the MAP loop.

    A solve calls :meth:`start` once, :meth:`begin_em` at each EM
    iteration, then per MAP iteration ``step(gate)`` (one ``ctypes`` call,
    one launch) and :meth:`flag` (one wait; the bits are ``ref.FLAG_*``).
    ``labels``, ``hood_e``, ``votes`` and ``stats`` are views of the
    buffers after the last step, valid until the next.
    """

    def __init__(self, hoods, model, *, precision: str = "f32", conv_tol: float = 1.0e-4,
                 window: int = 3):
        _check_precision(precision)
        n_labels = model.n_labels
        _check_labels("TickWorkspace", n_labels)
        dev = hoods.vertex.device
        if dev.type != "cuda":
            raise ValueError(f"TickWorkspace needs CUDA tensors, got {dev}")
        if hoods.offsets is None:
            raise ValueError("TickWorkspace needs the hoods' offsets (a whole problem, not a shard)")
        nh, nv = hoods.n_hoods, hoods.n_regions + 1
        f32, i32 = torch.float32, torch.int32
        self.capacity = hoods.capacity
        _require_ws(hoods.vertex, "vertex", i32, (self.capacity,), dev)
        _require_ws(hoods.offsets, "offsets", i32, (nh + 1,), dev)
        _require_ws(model.region_mean, "region_mean", f32, (nv,), dev)
        _require_ws(model.region_weight, "region_weight", f32, (nv,), dev)
        self.device, self.precision, self.n_labels = dev, precision, n_labels
        self.n_hoods, self.n_vertices = nh, nv
        self._beta = model.beta.to(f32).reshape(1).contiguous()
        _require_ws(self._beta, "beta", f32, (1,), dev)
        self._labels = torch.zeros((2, nv), dtype=i32, device=dev)
        self._votes = torch.zeros((2, n_labels, nv), dtype=f32, device=dev)
        self.ring = torch.zeros((window + 1, nh), dtype=f32, device=dev)
        self.hood_e = torch.zeros((nh,), dtype=f32, device=dev)
        self.stats = torch.zeros((3, n_labels), dtype=f32, device=dev)
        self._words = torch.zeros((3,), dtype=i32, device=dev)  # flag, ticket, accumulator
        self._host = _HostWord()
        self._keep = (hoods.vertex, hoods.offsets, model.region_mean, model.region_weight)
        self._plan = p = _TickPlan()
        p.vertex, p.offsets = hoods.vertex.data_ptr(), hoods.offsets.data_ptr()
        p.region_mean, p.region_weight = model.region_mean.data_ptr(), model.region_weight.data_ptr()
        p.beta = self._beta.data_ptr()
        p.labels[0], p.labels[1] = self._labels[0].data_ptr(), self._labels[1].data_ptr()
        p.votes[0], p.votes[1] = self._votes[0].data_ptr(), self._votes[1].data_ptr()
        p.ring, p.hood_e, p.stats = self.ring.data_ptr(), self.hood_e.data_ptr(), self.stats.data_ptr()
        p.flag_dev, p.sync = self._words.data_ptr(), self._words[1:].data_ptr()
        p.flag_host_dev, p.flag_host = self._host.device, self._host.host
        p.hist_rows, p.n_hoods, p.n_vertices, p.n_labels = window + 1, nh, nv, n_labels
        p.bf16, p.device, p.conv_tol = int(precision == "bf16"), dev.index or 0, conv_tol
        self._addr = ctypes.addressof(p)
        self._step = _entry("repro_em_tick_step")
        self._wait = _entry("repro_em_tick_wait")
        self._flag = ctypes.c_int(0)
        self._flag_addr = ctypes.addressof(self._flag)
        self._rows = window + 1
        self.parity = 0  # labels[parity] holds the current labels, votes[parity] is zero
        self.head = 0    # ring row of the newest hood energies

    def start(self, y, w, nall_e, valid, labels0) -> None:
        """Bind a solve's element arrays (``energy.StaticMapContext``) and
        copy its initial labels in; the MAP loop runs on the current
        stream."""
        dev, f32 = self.device, torch.float32
        for name, t in (("y", y), ("w", w), ("nall_e", nall_e), ("valid", valid)):
            _require_ws(t, name, f32, (self.capacity,), dev)
        _require_ws(labels0, "labels0", torch.int32, (self.n_vertices,), dev)
        self._elements = (y, w, nall_e, valid)
        p = self._plan
        p.y, p.w, p.nall, p.valid = (t.data_ptr() for t in self._elements)
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

    def step(self, gate: bool) -> None:
        """One MAP iteration: one launch; ``gate`` opens the flag's
        converged bit (the driver's MAP iteration count passed WINDOW)."""
        global launches
        self._step(self._addr, self.parity, self.head, 1 if gate else 0)
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
