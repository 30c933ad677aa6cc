"""Data-parallel primitives (DPPs): the paper's building-block vocabulary
(Map, Reduce, ReduceByKey, Scan, Scatter, Gather, SortByKey, Unique) on
PyTorch tensors.

Counterpart of ``repro.core.dpp``.  PyTorch has dynamic shapes, but the
compacting primitives keep the reference's padded form (a full-length
array plus a ``count``) so that arrays built from them, such as the hood
arrays, have the reference's shapes.  Scatter drops out-of-range and
masked lanes, as XLA's scatter does.

``reduce_by_key`` is the one primitive with a kernel behind it: float
``add``/``min`` go through ``kernels.ops.segment_reduce`` (the CUDA kernel
for a CUDA tensor) at any segment count, ``ordered=True`` asking for the
sum in element order; integer values stay on ``index_add_``.

Every primitive records its wall time into the active :class:`DppProfile`
(:func:`profiled`), the per-primitive breakdown of the paper's section
4.3.2; outside :func:`profiled` nothing is timed and nothing waits.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor

_INT64_MAX = 2**63 - 1
#: The largest key or index the ``segment_reduce`` kernel takes (int32).
INT32_MAX = 2**31 - 1

# ---------------------------------------------------------------------------
# Profiling (per-DPP breakdown, paper section 4.3.2)
# ---------------------------------------------------------------------------

_tls = threading.local()


@dataclass
class DppProfile:
    """Per-primitive wall times (seconds), one entry per call."""

    events: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, name: str, seconds: float) -> None:
        self.events.setdefault(name, []).append(seconds)

    def totals(self) -> Dict[str, float]:
        return {k: float(sum(v)) for k, v in self.events.items()}

    def counts(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.events.items()}


@contextlib.contextmanager
def profiled():
    """Time every primitive called inside the block; yields the profile.
    Each timed call waits for its result's device
    (``torch.cuda.synchronize``), so the times are the primitives' own."""
    prof = DppProfile()
    prev = getattr(_tls, "profile", None)
    _tls.profile = prof
    try:
        yield prof
    finally:
        _tls.profile = prev


def _first_tensor(out) -> Optional[Tensor]:
    if isinstance(out, Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _timed(name: str, fn: Callable[[], Any]) -> Any:
    prof = getattr(_tls, "profile", None)
    if prof is None:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    prof.record(name, time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# Canonical primitives
# ---------------------------------------------------------------------------


def map_(fn: Callable[..., Tensor], *arrays: Tensor) -> Tensor:
    """Map: apply ``fn`` elementwise over the input arrays (same shape)."""
    return _timed("Map", lambda: fn(*arrays))


def reduce_(values: Tensor, op: str = "add", initial: Optional[float] = None) -> Tensor:
    """Reduce: one aggregate over every element, a 0-d tensor."""

    def run():
        if op == "add":
            return torch.sum(values)
        if op in ("min", "max"):
            out = torch.amin(values) if op == "min" else torch.amax(values)
            if initial is None:
                return out
            init = torch.tensor(initial, dtype=out.dtype, device=out.device)
            return torch.minimum(out, init) if op == "min" else torch.maximum(out, init)
        raise ValueError(f"unknown reduce op: {op}")

    return _timed("Reduce", run)


def gather_(values: Tensor, indices: Tensor) -> Tensor:
    """Gather: ``out[i] = values[indices[i]]`` (leading axis)."""
    return _timed("Gather", lambda: values[indices.long()])


def scatter_(
    values: Tensor,
    indices: Tensor,
    out_size: int,
    *,
    mode: str = "set",
    fill: Any = 0,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Scatter: write ``values[i]`` to ``out[indices[i]]`` of an
    ``out_size``-long array that starts at ``fill``.

    ``mode`` is ``set``/``add``/``min``/``max``.  Indices are read as the
    reference's ``.at[]`` reads them: ``-out_size..-1`` count from the end,
    others outside ``[0, out_size)`` are dropped, and so are the lanes where
    ``mask`` is false (the masked-compaction idiom).  ``add`` adds in
    element order on the CPU (``index_add_``); where ``set`` writes one
    index twice, which write lands is unspecified, as in the reference.
    """
    if mode not in ("set", "add", "min", "max"):
        raise ValueError(f"unknown scatter mode: {mode}")

    def run():
        idx = indices.long()
        idx = torch.where(idx < 0, idx + out_size, idx)
        if mask is not None:
            idx = torch.where(mask, idx, out_size)
        idx = torch.where((idx >= 0) & (idx < out_size), idx, out_size)  # spare row, dropped
        out = torch.full((out_size + 1,) + tuple(values.shape[1:]), fill,
                         dtype=values.dtype, device=values.device)
        if mode == "set":
            out[idx] = values
        elif mode == "add":
            out.index_add_(0, idx, values)
        else:
            shaped = idx.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
            out.scatter_reduce_(0, shaped, values, "amin" if mode == "min" else "amax",
                                include_self=True)
        return out[:out_size]

    return _timed("Scatter", run)


def sort_by_key(keys: Tensor, *values: Tensor) -> Tuple[Tensor, ...]:
    """SortByKey: stable ascending sort of ``keys`` carrying ``values``."""

    def run():
        sorted_keys, order = torch.sort(keys, stable=True)
        return (sorted_keys,) + tuple(v[order] for v in values)

    return _timed("SortByKey", run)


def scan_(values: Tensor, *, exclusive: bool = False, axis: int = 0) -> Tensor:
    """Scan: prefix sum.  ``exclusive=True`` shifts by one (identity first),
    formed as the reference forms it: the inclusive sum less each value."""

    def run():
        inc = torch.cumsum(values, dim=axis)
        return inc - values if exclusive else inc

    return _timed("Scan", run)


def compound_key(
    major: Tensor, minor: Tensor, minor_span: int, *, major_span: Optional[int] = None
) -> Tensor:
    """Pack (major, minor) int pairs into one sortable int64 key.

    ``minor_span`` is an exclusive bound on ``minor``.  When ``major_span``
    (exclusive bound on ``major``) is given, the packed key space is
    checked against int64 and an overflow raises instead of mis-sorting.
    The reference packs into int32 unless JAX's 64-bit mode is on; PyTorch
    always has int64, so the bound here is 2**63 - 1.
    """
    if major_span is not None:
        max_key = int(major_span) * int(minor_span) - 1
        if max_key > _INT64_MAX:
            raise OverflowError(
                f"compound_key space {major_span} x {minor_span} does not fit int64"
            )
    return major.to(torch.int64) * minor_span + minor.to(torch.int64)


def lane_keys(keys: Tensor, span: int) -> Tensor:
    """Offset each lane's keys into a key range of its own: ``keys`` is
    (B, n) with every key in ``[0, span)``, the result the (B * n,) int64
    keys ``b * span + key``, lane after lane.  A flat keyed reduction over
    them into ``B * span`` segments is one reduction per lane, with each
    segment's elements in the lane's own order.  Raises ``OverflowError``
    when ``B * span`` keys do not fit int32, the kernel's id type."""
    n_lanes = int(keys.shape[0])
    if n_lanes * int(span) - 1 > INT32_MAX:
        raise OverflowError(f"{n_lanes} lanes of {span} keys do not fit int32")
    lane = torch.arange(n_lanes, dtype=torch.int64, device=keys.device)[:, None] * int(span)
    return (keys.to(torch.int64) + lane).reshape(-1)


def reduce_by_key(
    segment_ids: Tensor,
    values: Tensor,
    num_segments: int,
    op: str = "add",
    *,
    backend: Optional[str] = None,
    ordered: bool = False,
) -> Tensor:
    """ReduceByKey into ``num_segments`` buckets; ids outside
    ``[0, num_segments)`` are dropped.

    Float ``add``/``min`` dispatch to ``kops.segment_reduce`` with
    ``backend`` (ids as int32, the kernel's id type); ``ordered=True``
    sums each segment in element order, the CPU's and the reference's
    order, where the kernel's default ``add`` is order-free.  Integer
    ``add`` runs on ``index_add_``, exact in any order.
    """
    if op not in ("add", "min"):
        raise ValueError(f"unknown reduce_by_key op: {op}")
    if ordered and op != "add":
        raise ValueError("ordered=True is a property of the sum; min is order-free")

    def run():
        if values.is_floating_point():
            return kops.segment_reduce(
                values, segment_ids.to(torch.int32), num_segments, op, backend=backend,
                ordered=ordered,
            )
        if op != "add":
            raise ValueError(f"integer reduce_by_key supports 'add' only, got {op!r}")
        return kref.keyed_sum(values, segment_ids, num_segments)

    return _timed("ReduceByKey", run)


def unique_(sorted_values: Tensor, *, fill: Any = 0) -> Tuple[Tensor, Tensor]:
    """Unique: drop adjacent duplicates from a sorted 1-D tensor.

    Returns ``(padded_uniques, count)``: the input's length, the first
    ``count`` lanes holding the uniques in order and the rest ``fill``.
    """

    def run():
        n = sorted_values.shape[0]
        uniq = torch.unique_consecutive(sorted_values)
        out = torch.full((n,), fill, dtype=sorted_values.dtype, device=sorted_values.device)
        out[: uniq.shape[0]] = uniq
        return out, torch.tensor(uniq.shape[0], device=sorted_values.device)

    return _timed("Unique", run)


# ---------------------------------------------------------------------------
# Composite DPP idioms of the paper's pipeline
# ---------------------------------------------------------------------------


def counts_to_offsets(counts: Tensor) -> Tensor:
    """CSR offsets from per-row counts: length ``n + 1``, int32."""
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=counts.device)
    offsets[1:] = torch.cumsum(counts.to(torch.int64), 0)
    return offsets.to(torch.int32)


def expand(counts: Tensor, total: int) -> Tensor:
    """The DPP expand idiom (the paper's repHoods construction): for
    ``total`` output lanes, the row each lane belongs to, row ``i``
    repeated ``counts[i]`` times; lanes beyond ``sum(counts)`` get
    ``len(counts)``, an out-of-range sentinel.  int32."""
    return expand_with_rank(counts, total)[0]


def expand_with_rank(counts: Tensor, total: int) -> Tuple[Tensor, Tensor]:
    """:func:`expand` and each lane's rank within its row (0 on the
    sentinel lanes)."""
    n = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int64)
    src = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    if src.shape[0] > total:
        raise ValueError(f"expand: sum(counts) = {src.shape[0]} exceeds total = {total}")
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(src.shape[0], device=dev) - starts[src]
    pad = total - src.shape[0]
    src = torch.cat([src, torch.full((pad,), n, dtype=torch.int64, device=dev)])
    rank = torch.cat([rank, torch.zeros((pad,), dtype=torch.int64, device=dev)])
    return src.to(torch.int32), rank.to(torch.int32)


def segments_from_sorted(sorted_keys: Tensor) -> Tensor:
    """Dense segment ids (0..k-1) of a sorted key array: a Scan over the
    flags of the positions where the key changes.  int32."""
    is_new = torch.zeros(sorted_keys.shape[0], dtype=torch.int32, device=sorted_keys.device)
    is_new[1:] = (sorted_keys[1:] != sorted_keys[:-1]).to(torch.int32)
    return scan_(is_new).to(torch.int32)


def select_flagged(values: Tensor, flags: Tensor, *, fill: Any = 0) -> Tuple[Tensor, Tensor]:
    """Stream compaction: the lanes where ``flags`` is true, packed in
    order at the front of an array of the input's length (the rest
    ``fill``), and their count (0-d).  Scan + Scatter."""
    flags_i = flags.to(torch.int64)
    pos = scan_(flags_i, exclusive=True)
    packed = scatter_(values, pos, values.shape[0], mode="set", fill=fill, mask=flags.bool())
    return packed, torch.sum(flags_i)


__all__ = [
    "DppProfile",
    "profiled",
    "map_",
    "reduce_",
    "scan_",
    "gather_",
    "scatter_",
    "sort_by_key",
    "compound_key",
    "reduce_by_key",
    "unique_",
    "counts_to_offsets",
    "expand",
    "expand_with_rank",
    "segments_from_sorted",
    "select_flagged",
]
