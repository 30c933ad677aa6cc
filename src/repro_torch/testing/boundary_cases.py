"""EM-boundary cases for the boundary kernel and its plain version
(``kernels.ref.em_boundary``/``em_boundary_lanes``): a stack's boundary
state drawn from a numpy seed, with lanes that reach every branch.

Each lane of a case is one of ``LANE_KINDS``:

* ``plain``: random M-step sums of a few labels, a MAP loop of some
  iterations, a flag word with the converged bit;
* ``dead_label``: one label with (almost) no mass, which the M-step
  reseeds;
* ``degenerate``: a dead real label whose reseed sigma is ``sigma_min``;
* ``nan_sums``: a NaN among the sums (the parameters diverge);
* ``flag_diverged``: the MAP loop's ``FLAG_DIVERGED``;
* ``no_map``: a MAP loop that ran no iteration (the sums read as zeros);
* ``converging``: a total-energy ring equal to the lane's total energy, so
  the window test passes once the EM iteration is past ``window``;
* ``inert_label``: a dead label at ``energy.INERT_MU`` (never degenerate);
* ``stopped``: a lane whose EM has finished (its state must not move).

``em_i`` (the program's EM iterations before the boundary) is set by the
caller: ``EM_ITERS`` runs it around the window and ``MAX_EM_ITERS``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref

LANE_KINDS = ("plain", "dead_label", "degenerate", "nan_sums", "flag_diverged", "no_map",
              "converging", "inert_label", "stopped")
WINDOW = 3
MAX_EM_ITERS = 6
MAX_MAP_ITERS = 10
#: The program's EM iterations before the boundary: the boundary makes
#: em_i + 1, so these put it before, at and past the window, and at the cap.
EM_ITERS = (WINDOW - 1, WINDOW, WINDOW + 1, MAX_EM_ITERS - 1)
SIGMA_MIN = 2.0


def boundary_state(seed: int, n_labels: int, n_hoods: int = 37, em_i: int = WINDOW) -> ref.BoundaryState:
    """One stack of ``len(LANE_KINDS)`` lanes (CPU tensors), lane b of kind
    ``LANE_KINDS[b]``."""
    rng = np.random.default_rng(seed)
    b, k, rows = len(LANE_KINDS), n_labels, WINDOW + 1
    f32 = np.float32
    mu = np.sort(rng.uniform(10.0, 240.0, (b, k)), axis=1).astype(f32)
    sd = rng.uniform(3.0, 30.0, (b, k)).astype(f32)
    sum_w = rng.uniform(5.0, 400.0, (b, k)).astype(f32)
    sum_wy = (sum_w * mu).astype(f32)
    sum_wyy = (sum_w * (mu.astype(np.float64) ** 2 + sd.astype(np.float64) ** 2)).astype(f32)
    stats = np.stack([sum_w, sum_wy, sum_wyy], axis=1)
    hood_e = rng.uniform(-50.0, 400.0, (b, n_hoods)).astype(f32)
    lane = np.zeros((len(ref.LANE_WORDS), b), dtype=np.int32)
    lane[ref.MAP_I] = rng.integers(1, MAX_MAP_ITERS + 1, b)
    lane[ref.FLAG] = rng.integers(0, 2, b)  # the converged bit or 0
    lane[ref.RUNNING] = 1
    lane[ref.EM_ITERS] = em_i
    lane[ref.MAP_ITERS] = rng.integers(em_i, 8 * em_i + 1, b)
    reseed_mu = np.sort(rng.uniform(10.0, 240.0, (b, k)), axis=1).astype(f32)
    reseed_sigma = rng.uniform(3.0, 20.0, b).astype(f32)
    total_hist = rng.uniform(1000.0, 9000.0, (b, rows)).astype(f32)
    kind = {name: j for j, name in enumerate(LANE_KINDS)}
    stats[kind["dead_label"], :, 0] = 0.0
    d = kind["degenerate"]
    stats[d, :, 0] = 0.0
    reseed_sigma[d] = SIGMA_MIN
    stats[kind["nan_sums"], 1, k - 1] = np.nan
    lane[ref.FLAG, kind["flag_diverged"]] = ref.FLAG_DIVERGED
    lane[ref.MAP_I, kind["no_map"]] = 0
    c = kind["converging"]
    total_hist[c] = np.float32(hood_e[c].astype(np.float64).sum())
    i = kind["inert_label"]
    stats[i, :, k - 1] = 0.0
    reseed_mu[i, k - 1] = 1.0e8
    s = kind["stopped"]
    lane[ref.RUNNING, s] = 0
    lane[ref.STATUS, s] = 1
    ctl = np.zeros(len(ref.CTL_WORDS), dtype=np.int32)
    ctl[ref.EM_I] = em_i
    ctl[ref.STEPS] = int(lane[ref.MAP_ITERS].max())
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return ref.BoundaryState(
        stats=t(stats), hood_e=t(hood_e), lane=t(lane), ctl=t(ctl),
        em_mu=t(rng.uniform(0.0, 255.0, (b, k)).astype(f32)),
        em_sigma=t(rng.uniform(1.0, 40.0, (b, k)).astype(f32)),
        mu=t(rng.uniform(0.0, 255.0, (b, k)).astype(f32)),
        sigma=t(rng.uniform(1.0, 40.0, (b, k)).astype(f32)),
        ring=t(rng.normal(0.0, 100.0, (b, rows, n_hoods)).astype(f32)),
        total_hist=t(total_hist), sigma_min=t(np.full(b, SIGMA_MIN, f32)),
        reseed_mu=t(reseed_mu), reseed_sigma=t(reseed_sigma))


def cases(n_labels=(2, 3, 9)):
    """Every (K, em_i) case: ``(name, state)``, the states CPU tensors."""
    return [(f"K={k} em_i={e}", boundary_state(100 * k + e, k, em_i=e))
            for k in n_labels for e in EM_ITERS]


def clone(st: ref.BoundaryState, device=None) -> ref.BoundaryState:
    return ref.BoundaryState(*(t.clone() if device is None else t.to(device) for t in st))


def lane_state(st: ref.BoundaryState, b: int) -> ref.BoundaryState:
    """Lane ``b`` of a stack's state as the single form's (copies; the
    program's words the stack's)."""
    return ref.BoundaryState(*(t.clone() if t is st.ctl else t[:, b].clone() if t is st.lane
                               else t[b].clone() for t in st))


def unequal(a: ref.BoundaryState, b: ref.BoundaryState) -> list:
    """The fields of two states that differ, bit for bit (a NaN equals a
    NaN)."""
    out = []
    for name, x, y in zip(ref.BoundaryState._fields, a, b):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.dtype == torch.float32:
            nan = torch.isnan(x) & torch.isnan(y)
            same = torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
                x.view(torch.int32)[~nan], y.view(torch.int32)[~nan])
        else:
            same = torch.equal(x, y)
        if not same:
            out.append(name)
    return out
