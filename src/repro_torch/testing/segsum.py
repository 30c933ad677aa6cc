"""A numpy model of the ``segment_reduce`` kernel's arithmetic.

``csrc/segsum.cuh`` sums float32 values by key without a floating-point
atomic, so that the result does not depend on the order in which the
elements arrive (pre-rounding in the spirit of Demmel and Nguyen's
reproducible summation):

1. For each segment, the largest exponent of a finite non-zero value
   (``exponent_key``: the float's biased exponent field, at least 1) and
   the non-finite flags (NaN, +inf, -inf) seen.
2. Each finite value is rounded, half to even, to a multiple of ``2**q``
   with ``q = key - 126 - frac_bits(n)`` for its segment's key and the
   call's element count ``n``: an int64 below ``2**frac_bits(n)`` in
   magnitude.  ``frac_bits(n) = 62 - ceil(log2 n)``, so ``n`` such integers
   sum below ``2**62`` and integer addition is exact in any order.
3. Read-out: the segment's integer sum rounded once to float32, then
   scaled by ``2**q`` (exact, unless the result is subnormal or
   overflows).  A NaN, or +inf and -inf together, give NaN; one infinity
   alone gives itself; a segment with no finite non-zero value gives 0.0.

``segment_min`` is the kernel's ``min``: a NaN wins over everything, a
-0.0 against +0.0 tie gives -0.0, an empty segment +inf.  Both functions
return what the kernel returns bit for bit (its NaN is ``QNAN_BITS``);
``chip_smoke.py`` holds the kernel to them on the card, and the CPU tests
hold them to ``jax.ops.segment_sum`` / ``segment_min``.  numpy only, so
that ``chip_smoke.py`` can use it without the JAX package.
"""

from __future__ import annotations

import numpy as np

QNAN_BITS = 0x7FC00000  # the NaN the kernel writes
NAN, POS_INF, NEG_INF = 1, 2, 4  # the non-finite flags of a segment


def ceil_log2(n: int) -> int:
    """``ceil(log2 n)`` for ``n >= 1``."""
    return max(int(n) - 1, 0).bit_length()


def frac_bits(n: int) -> int:
    """Bits of a value's grid below its segment's top exponent, for a call
    of ``n`` elements: ``n`` values of magnitude at most ``2**frac_bits(n)``
    sum below ``2**62``."""
    return 62 - ceil_log2(max(int(n), 1))


def exponent_key(values: np.ndarray) -> np.ndarray:
    """int32 per value: the biased exponent (at least 1, so subnormals
    count as the smallest normal) of a finite non-zero value, else 0."""
    v = np.asarray(values, np.float32)
    field = ((v.view(np.uint32) >> 23) & 0xFF).astype(np.int32)
    return np.where(np.isfinite(v) & (v != 0), np.maximum(field, 1), 0).astype(np.int32)


def nonfinite_flags(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, np.float32)
    return (np.isnan(v) * NAN + (v == np.inf) * POS_INF + (v == -np.inf) * NEG_INF).astype(np.int32)


def quantize(values: np.ndarray, keys: np.ndarray, n: int) -> np.ndarray:
    """Each value on its segment's grid (``keys`` per value): int64."""
    q = keys.astype(np.int64) - 126 - frac_bits(n)
    return np.rint(np.ldexp(np.asarray(values, np.float64), -q)).astype(np.int64)


def readout(acc: np.ndarray, keys: np.ndarray, flags: np.ndarray, n: int) -> np.ndarray:
    """float32 result of each segment from its integer sum, key and flags."""
    q = keys.astype(np.int64) - 126 - frac_bits(n)
    out = np.ldexp(acc.astype(np.float32).astype(np.float64), q).astype(np.float32)
    out[keys == 0] = 0.0
    both = (flags & (POS_INF | NEG_INF)) == (POS_INF | NEG_INF)
    out[(flags & POS_INF) != 0] = np.inf
    out[(flags & NEG_INF) != 0] = -np.inf
    out[((flags & NAN) != 0) | both] = np.array(QNAN_BITS, np.uint32).view(np.float32)
    return out


def _in_range(ids: np.ndarray, num_segments: int) -> np.ndarray:
    ids = np.asarray(ids, np.int64)
    return (ids >= 0) & (ids < num_segments)


def segment_sum(values: np.ndarray, ids: np.ndarray, num_segments: int) -> np.ndarray:
    """The kernel's float ``add``: (num_segments,) float32."""
    v = np.asarray(values, np.float32)
    n = v.shape[0]
    take = _in_range(ids, num_segments)
    seg, v = np.asarray(ids, np.int64)[take], v[take]
    keys = np.zeros(num_segments, np.int32)
    np.maximum.at(keys, seg, exponent_key(v))
    flags = np.zeros(num_segments, np.int32)
    np.bitwise_or.at(flags, seg, nonfinite_flags(v))
    finite = np.isfinite(v) & (v != 0)
    acc = np.zeros(num_segments, np.int64)
    np.add.at(acc, seg[finite], quantize(v[finite], keys[seg[finite]], n))
    return readout(acc, keys, flags, n)


def segment_min(values: np.ndarray, ids: np.ndarray, num_segments: int) -> np.ndarray:
    """The kernel's ``min``: (num_segments,) float32."""
    v = np.asarray(values, np.float32)
    take = _in_range(ids, num_segments)
    seg, v = np.asarray(ids, np.int64)[take], v[take]
    out = np.full(num_segments, np.inf, np.float32)
    ok = ~np.isnan(v)
    np.minimum.at(out, seg[ok], v[ok])
    neg_zero = np.zeros(num_segments, bool)
    np.logical_or.at(neg_zero, seg, (v == 0) & np.signbit(v))
    out[out == 0] = np.where(neg_zero[out == 0], np.float32(-0.0), np.float32(0.0))
    has_nan = np.zeros(num_segments, bool)
    np.logical_or.at(has_nan, seg, np.isnan(v))
    out[has_nan] = np.array(QNAN_BITS, np.uint32).view(np.float32)
    return out

