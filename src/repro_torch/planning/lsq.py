"""Least-squares machinery shared by the plan cost model and the serving
engine (counterpart of ``repro.planning.lsq``), numpy and the standard
library only.

* :class:`DecayedAffineFit`: the exponentially-decayed least-squares fit
  of ``cost(x) ~= a + b*x`` the serving engine runs online over its
  (micro-steps, tick seconds) observations for ``tick_iters="auto"``,
  seeded with the cost model's ``tick_cost_prior``.
* :func:`nnls`: the deterministic non-negative ridge least squares the
  calibration fit (``costmodel.fit_table``) solves, the reference's
  float64 computation operation for operation, so that a table refits to
  the reference's bytes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["DecayedAffineFit", "nnls"]


class DecayedAffineFit:
    """Exponentially-decayed least squares of ``y ~= a + b*x``.

    ``observe(x, y)`` decays every accumulated moment by ``decay`` and
    adds the new sample, so recent observations dominate (a tick's cost
    drifts with load).  ``fit()`` solves the decayed normal equations;
    with fewer than two effective samples or no spread in ``x`` it falls
    back to a mean split (30 % of the mean cost fixed, the rest marginal)
    and then to ``default``.  The intercept can be floored (``a_floor``):
    the engine passes its measured per-tick host overhead, since a fit
    over small ticks alone can drive ``a`` to zero and lock the adaptive
    policy into the smallest tick.
    """

    def __init__(self, decay: float = 0.95):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = decay
        # Decayed moments: sample count, sum x, sum y, sum x^2, sum x*y.
        self._n = self._sx = self._sy = self._sxx = self._sxy = 0.0
        self.observations = 0   # undecayed count

    def observe(self, x: float, y: float) -> None:
        d = self.decay
        self._n = self._n * d + 1.0
        self._sx = self._sx * d + x
        self._sy = self._sy * d + y
        self._sxx = self._sxx * d + x * x
        self._sxy = self._sxy * d + x * y
        self.observations += 1

    def fit(
        self,
        *,
        a_floor: float = 0.0,
        b_min: float = 1e-6,
        default: Tuple[float, float] = (5e-3, 5e-3),
    ) -> Tuple[float, float]:
        n, sx, sy, sxx, sxy = self._n, self._sx, self._sy, self._sxx, self._sxy
        if n >= 2.0:
            var = sxx - sx * sx / n
            if var > 1e-9:
                b = max((sxy - sx * sy / n) / var, b_min)
                a = max((sy - b * sx) / n, a_floor)
                return a, b
        if n > 0.0:
            mean_x, mean_y = sx / n, sy / n
            if mean_x > 0:
                return max(0.3 * mean_y, a_floor), max(0.7 * mean_y / mean_x, b_min)
        return max(default[0], a_floor), max(default[1], b_min)


def nnls(
    A: np.ndarray,
    y: np.ndarray,
    *,
    l2: float = 1e-9,
    iters: int = 4000,
    scale: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Non-negative least squares: ``argmin_{x>=0} ||Ax - y||^2 + l2||x'||^2``.

    Cyclic coordinate descent on the normal equations with projection to
    the non-negative orthant: deterministic (fixed iteration order and
    count, float64 throughout).  Columns are normalized to unit RMS so the
    ridge term and the convergence rate are scale-free across features
    spanning many orders of magnitude; ``scale`` overrides the factors.
    Non-negative coefficients keep every fitted prediction monotone in the
    execution axes.
    """
    A = np.asarray(A, np.float64)
    y = np.asarray(y, np.float64)
    if A.ndim != 2 or y.shape != (A.shape[0],):
        raise ValueError(f"shape mismatch: A {A.shape}, y {y.shape}")
    m, k = A.shape
    if scale is None:
        col_rms = np.sqrt(np.mean(A * A, axis=0))
        col_rms = np.where(col_rms > 0, col_rms, 1.0)
    else:
        col_rms = np.asarray(scale, np.float64)
        if col_rms.shape != (k,):
            raise ValueError(f"scale must have shape ({k},), got {col_rms.shape}")
    An = A / col_rms
    G = An.T @ An + l2 * np.eye(k)
    c = An.T @ y
    x = np.zeros(k, np.float64)
    for _ in range(iters):
        for j in range(k):
            gj = G[j, j]
            if gj <= 0.0:
                continue
            r = c[j] - G[j] @ x + gj * x[j]
            x[j] = max(r / gj, 0.0)
    return x / col_rms
