"""Peaked-softmax cases for holding the flash kernel to its plain version.

The usual check inputs (q and k scaled by 0.3, as ``tests/test_kernels.py``
makes them) give scaled scores that spread by about half a unit in a row,
so the softmax is almost flat and the running max barely moves from one
K/V tile to the next.  A kernel that never rescales its accumulator, or
never subtracts the running max, then stays well inside the 2e-2 limit.  Here q
is scaled up so that the scores spread by several units (and, in one case,
far enough that ``exp`` overflows float32 unless the max is subtracted),
and the error of each output row is measured relative to that row's
largest magnitude, so rows whose values are small are held as tightly as
the rest.

``online_softmax`` is the tensor-core kernel's algorithm in numpy (64-key
tiles, running max in log2 units, P rounded to bfloat16, l summed from the
unrounded P), with switches that break it the way a faulty kernel would.
The tests show that ``ROW_TOL`` accepts the right algorithm on every case
here, rejects the one without the rescale on every case, and rejects the
one without the max subtraction on the case whose ``exp`` overflows (below
overflow, not subtracting computes the same function).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

NEG_INF = -1e30
LOG2E = 1.4426950408889634

#: (B, Hq, Hkv, S, D), q's scale, causal.  The model's two shapes with
#: scores spread by several units (q x 10 and x 30), a D = 64 shape causal
#: and not, and the S = 1024 shape with scores far beyond float32's ``exp``
#: range (q x 1000).
PEAKED_CASES: List[Tuple[Tuple[int, int, int, int, int], float, bool]] = [
    ((1, 12, 2, 512, 128), 10.0, True),
    ((1, 12, 2, 1024, 128), 10.0, True),
    ((1, 12, 2, 512, 128), 30.0, True),
    ((1, 12, 2, 1024, 128), 30.0, True),
    ((2, 4, 2, 256, 64), 30.0, False),
    ((2, 4, 2, 256, 64), 30.0, True),
    ((1, 12, 2, 1024, 128), 1000.0, True),
]

#: Largest error of an output row over the row's largest |value|: four
#: bfloat16 steps (2^-8 each) of that value.
ROW_TOL = 4 * 2.0 ** -8

#: A case counts as peaked when the scaled scores of a row spread by at
#: least this much on average.
MIN_SPREAD = 2.0


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def peaked_inputs(shape, q_scale: float, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float32 q, k, v for a ``(B, Hq, Hkv, S, D)`` case, each value already
    a bfloat16: q ~ 0.3 * q_scale * N(0, 1), k ~ 0.3 * N(0, 1), v ~ N(0, 1)."""
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)) * (0.3 * q_scale)
    k = rng.standard_normal((b, hkv, s, d)) * 0.3
    v = rng.standard_normal((b, hkv, s, d))
    return tuple(bf16_round(a.astype(np.float32)) for a in (q, k, v))


def _scores(q: np.ndarray, k: np.ndarray, scale: float) -> np.ndarray:
    group = q.shape[1] // k.shape[1]
    return (q @ np.repeat(k, group, axis=1).swapaxes(-1, -2)) * np.float32(scale)


def score_spread(q: np.ndarray, k: np.ndarray, causal: bool) -> float:
    """Mean over rows of (largest - smallest) visible scaled score."""
    sc = _scores(q, k, q.shape[-1] ** -0.5)
    s = sc.shape[-1]
    visible = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    hi = np.where(visible, sc, -np.inf).max(-1)
    lo = np.where(visible, sc, np.inf).min(-1)
    return float((hi - lo).mean())


def row_relative_error(got: np.ndarray, want: np.ndarray) -> float:
    """Largest over rows of max |got - want| / max |want| (rows along the
    last axis); inf where ``got`` is not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        return float("inf")
    err = np.abs(got - want).max(-1)
    return float((err / np.maximum(np.abs(want).max(-1), 1e-30)).max())


def online_softmax(
    q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool, *,
    tile: int = 64, rescale: bool = True, subtract_max: bool = True,
) -> np.ndarray:
    """The tensor-core kernel's algorithm in float32 numpy, output rounded
    to bfloat16.  ``rescale=False`` leaves the accumulator unscaled when
    the running max grows; ``subtract_max=False`` takes ``exp2`` of the
    scores themselves."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kk, vv = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    scale = np.float32(d ** -0.5 * LOG2E)
    m = np.full((b, hq, s, 1), NEG_INF, np.float32)
    l = np.zeros((b, hq, s, 1), np.float32)
    o = np.zeros((b, hq, s, d), np.float32)
    rows = np.arange(s)[:, None]
    with np.errstate(over="ignore", invalid="ignore"):
        for t0 in range(0, s, tile):
            cols = np.arange(t0, min(t0 + tile, s))[None, :]
            sc = (q @ kk[:, :, t0:t0 + tile].swapaxes(-1, -2)) * scale
            if causal:
                sc = np.where(cols <= rows, sc, np.float32(NEG_INF))
            mx = np.maximum(m, sc.max(-1, keepdims=True)) if subtract_max else np.zeros_like(m)
            c = np.exp2(m - mx) if subtract_max else np.ones_like(m)
            p = np.exp2(sc - mx)
            l = l * c + p.sum(-1, keepdims=True)
            if rescale:
                o = o * c
            o = o + bf16_round(p) @ vv[:, :, t0:t0 + tile]
            m = mx
        return bf16_round(o / np.maximum(l, np.float32(1e-30)))
