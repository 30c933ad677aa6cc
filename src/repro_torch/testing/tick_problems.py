"""Random operands for the EM-tick kernel, padding and validity included.

``random_tick_problem`` draws the operands of one tick the way a padded
problem carries them: about a tenth of the elements are padding
(``valid == 0``, zero ``y``/``w``/``xf``), hood ids are drawn unsorted and
the history ring holds one live row above rows of 1e9, so the
convergence flag is false.  ``sorted_tick_problem`` puts the elements in
the layout the CUDA kernel takes, sorted by (hood, vertex) as
``build_hoods`` leaves them, and adds the hoods' run boundaries.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

WINDOW = 3  # convergence window of the EM driver (history ring has WINDOW+1 rows)

#: Order of the arrays returned below (the positional order of fused_em_tick).
FIELDS = (
    "y", "w", "nall_e", "xf", "valid", "hood_id", "vertex",
    "region_mean", "region_weight", "hist", "mu", "sigma",
)


def random_tick_problem(
    seed: int, n_labels: int, n_hoods: int, n_vertices: int, n: int
) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    hood_id = rng.integers(0, n_hoods, n).astype(np.int32)
    vertex = rng.integers(0, n_vertices - 1, n).astype(np.int32)
    valid = (rng.random(n) < 0.9).astype(np.float32)
    y = rng.normal(100, 30, n).astype(np.float32) * valid
    w = rng.random(n).astype(np.float32) * valid
    nall_e = rng.integers(1, 9, n).astype(np.float32)
    labels0 = rng.integers(0, n_labels, n_vertices).astype(np.int32)
    xf = labels0[vertex].astype(np.float32) * valid
    region_mean = rng.normal(100, 30, n_vertices).astype(np.float32)
    region_weight = rng.random(n_vertices).astype(np.float32)
    hist = np.full((WINDOW + 1, n_hoods), 1e9, np.float32)
    hist[0] = rng.random(n_hoods).astype(np.float32) * 10
    mu = np.linspace(60, 140, n_labels).astype(np.float32)
    sigma = np.linspace(8, 14, n_labels).astype(np.float32)
    return [y, w, nall_e, xf, valid, hood_id, vertex,
            region_mean, region_weight, hist, mu, sigma]


def sorted_tick_problem(
    seed: int, n_labels: int, n_hoods: int, n_vertices: int, n: int
) -> Tuple[List[np.ndarray], np.ndarray]:
    """``random_tick_problem`` with the elements sorted by (hood, vertex);
    returns ``(arrays, offsets)`` with hood ``h`` owning elements
    ``offsets[h]:offsets[h+1]``."""
    arrays = random_tick_problem(seed, n_labels, n_hoods, n_vertices, n)
    hood_id, vertex = arrays[5], arrays[6]
    order = np.lexsort((vertex, hood_id))
    for i in range(7):  # the per-element arrays
        arrays[i] = np.ascontiguousarray(arrays[i][order])
    offsets = np.searchsorted(arrays[5], np.arange(n_hoods + 1)).astype(np.int32)
    return arrays, offsets
