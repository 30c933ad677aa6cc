"""The exponentially-decayed least-squares fit of ``cost(x) ~= a + b*x``
(counterpart of ``repro.planning.lsq.DecayedAffineFit``), numpy and the
standard library only.

The serving engine runs it online over its (micro-steps, tick seconds)
observations for ``tick_iters="auto"``.  The reference's calibrated cost
model (and its ``nnls`` fitter) is not ported yet, so the fit's cold-start
prior is the reference's own fallback, ``(5e-3, 5e-3)``.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["DecayedAffineFit"]


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
