"""Reference implementations the paper compares against (§4.1.4, §4.3).

Counterpart of ``repro.core.pmrf.reference``: the port's own copy, in
NumPy, taking the port's ``Hoods`` and ``EnergyModel`` (their tensors, on
any device, are read into NumPy arrays first; so are the initial labels
and parameters).


* ``serial_em``   — the serial baseline: plain-Python/numpy loops over
  neighborhoods with per-element inner loops, the "Serial CPU" row of
  paper Table 1.
* ``coarse_em``   — the OpenMP-analogue PMRF: *outer* parallelism over
  neighborhoods (each neighborhood's optimization is one task, vectorized
  per-neighborhood like a single OpenMP thread's work), with NO inner
  fine-grained parallelism and the ragged per-neighborhood memory layout
  the paper attributes the OpenMP code's cache behaviour to.
* ``golden_em``   — the golden test oracle (DESIGN.md §13): a pure-NumPy
  float32 transcription of the K-ary static-mode driver with the *same
  accumulation order* as XLA's segment reductions, so its labels,
  parameters, and iteration counts are bit-identical to ``run_em`` on CPU
  (the JAX package asserts it in ``tests/test_golden.py``).

All three are K-ary (the label count rides on ``mu0``'s length, matching
the engine's convention).  ``serial_em``/``coarse_em`` compute the same
energies/updates as the DPP engine in float64 (numerically equal labels
given the same schedule), so runtime ratios isolate the execution model —
the paper's experimental design.  ``golden_em`` trades their float64
comfort for exact float32 trajectory parity.

``coarse_em`` runs on one core, the coarse-grained formulation at
concurrency 1 (the paper's p=1 column).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core.pmrf.energy import EnergyModel
from repro_torch.core.pmrf.hoods import Hoods

WINDOW = 3
CONV_TOL = 1.0e-4


def _np(x, dtype=None) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a scalar) as a NumPy
    array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


@dataclass
class RefResult:
    labels: np.ndarray
    mu: np.ndarray
    sigma: np.ndarray
    em_iters: int
    map_iters: int
    total_energy: float
    seconds: float


def _ragged_hoods(hoods: Hoods) -> List[np.ndarray]:
    """The reference ragged-array layout: one row of vertex ids per
    neighborhood (the OpenMP code's data structure)."""
    vertex = _np(hoods.vertex)
    hood_id = _np(hoods.hood_id)
    valid = _np(hoods.valid)
    rows: List[np.ndarray] = [
        vertex[(hood_id == h) & valid] for h in range(hoods.n_hoods)
    ]
    return rows


def _label_energy_vertex(
    y: float, w: float, label: int, mu, sigma, n_diff: float, denom: float, beta: float
) -> float:
    d = y - mu[label]
    data = w * (d * d / (2.0 * sigma[label] * sigma[label]) + np.log(sigma[label]))
    return data + beta * max(n_diff, 0.0) / denom


def _em_generic(
    hoods: Hoods,
    model: EnergyModel,
    labels0: np.ndarray,
    mu0: np.ndarray,
    sigma0: np.ndarray,
    *,
    mode: str,                     # "serial" | "coarse"
    max_em_iters: int = 20,
    max_map_iters: int = 10,
) -> RefResult:
    rows = _ragged_hoods(hoods)
    y_all = _np(model.region_mean)
    w_all = _np(model.region_weight)
    beta = float(model.beta)
    sig_min = float(model.sigma_min)
    reseed_mu = _np(model.reseed_mu)
    reseed_sigma = float(model.reseed_sigma)
    n_regions = hoods.n_regions
    n_labels = int(_np(mu0).shape[0])

    labels = _np(labels0).copy()
    mu = _np(mu0, np.float64).copy()
    sigma = _np(sigma0, np.float64).copy()

    t0 = time.perf_counter()
    em_iters = 0
    map_total = 0
    hood_e = np.zeros(len(rows), np.float64)
    total_hist = np.zeros(WINDOW + 1, np.float64)

    for em in range(max_em_iters):
        em_iters += 1
        hist = np.zeros((WINDOW + 1, len(rows)), np.float64)

        for it in range(max_map_iters):
            map_total += 1
            votes = np.zeros((n_regions + 1, n_labels), np.float64)
            sig = np.maximum(sigma, sig_min)

            if mode == "serial":
                # fully serial: explicit python loop over rows AND elements
                for h, row in enumerate(rows):
                    if len(row) == 0:
                        hood_e[h] = 0.0
                        continue
                    x_row = labels[row]
                    cnt = np.bincount(x_row, minlength=n_labels).astype(np.float64)
                    nall = float(len(row))
                    denom = max(nall - 1.0, 1.0)
                    esum = 0.0
                    for j, v in enumerate(row):
                        yv, wv, xv = float(y_all[v]), float(w_all[v]), int(x_row[j])
                        best, best_e = 0, None
                        for l in range(n_labels):
                            diff = (nall - cnt[l]) - (0.0 if xv == l else 1.0)
                            e_l = _label_energy_vertex(
                                yv, wv, l, mu, sig, diff, denom, beta
                            )
                            if best_e is None or e_l < best_e:
                                best, best_e = l, e_l
                        esum += best_e
                        votes[v, best] += 1.0
                    hood_e[h] = esum
            else:
                # coarse outer-parallel: per-neighborhood vectorized numpy
                # (one OpenMP task's work), python loop over neighborhoods
                for h, row in enumerate(rows):
                    if len(row) == 0:
                        hood_e[h] = 0.0
                        continue
                    yv = y_all[row]
                    wv = w_all[row]
                    x_row = labels[row]
                    cnt = np.bincount(x_row, minlength=n_labels).astype(np.float64)
                    nall = float(len(row))
                    denom = max(nall - 1.0, 1.0)
                    es = []
                    for l in range(n_labels):
                        d = yv - mu[l]
                        eq = (x_row == l).astype(np.float64)
                        es.append(
                            wv * (d * d / (2 * sig[l] * sig[l]) + np.log(sig[l]))
                            + beta * np.maximum(
                                (nall - cnt[l]) - (1.0 - eq), 0.0
                            ) / denom
                        )
                    e_mat = np.stack(es)
                    pick = np.argmin(e_mat, axis=0)
                    hood_e[h] = e_mat[pick, np.arange(len(row))].sum()
                    np.add.at(votes, (row, pick), 1.0)

            labels = np.argmax(votes, axis=1).astype(np.int32)
            labels = np.concatenate([labels[:n_regions], [0]])
            hist = np.roll(hist, 1, axis=0)
            hist[0] = hood_e
            if it > WINDOW:
                deltas = np.abs(hist[:-1] - hist[1:])
                scale = np.maximum(np.abs(hist[0]), 1.0)
                if (deltas < CONV_TOL * scale).all():
                    break

        # M-step
        w_eff = w_all[:-1]
        y_eff = y_all[:-1]
        lab_eff = labels[:n_regions]
        for l in range(n_labels):
            sel = lab_eff == l
            sw = float(w_eff[sel].sum())
            if sw < 1e-3 * float(w_eff.sum()):
                mu[l] = reseed_mu[l]
                sigma[l] = reseed_sigma
                continue
            mu[l] = float((w_eff[sel] * y_eff[sel]).sum()) / sw
            var = float((w_eff[sel] * (y_eff[sel] - mu[l]) ** 2).sum()) / sw
            sigma[l] = max(np.sqrt(var), sig_min)

        total = float(hood_e.sum())
        total_hist = np.roll(total_hist, 1)
        total_hist[0] = total
        if em > WINDOW:
            deltas = np.abs(total_hist[:-1] - total_hist[1:])
            scale = max(abs(total_hist[0]), 1.0)
            if (deltas < CONV_TOL * scale).all():
                break

    return RefResult(
        labels=labels,
        mu=mu.astype(np.float32),
        sigma=sigma.astype(np.float32),
        em_iters=em_iters,
        map_iters=map_total,
        total_energy=float(hood_e.sum()),
        seconds=time.perf_counter() - t0,
    )


def serial_em(hoods, model, labels0, mu0, sigma0, **kw) -> RefResult:
    return _em_generic(hoods, model, labels0, mu0, sigma0, mode="serial", **kw)


def coarse_em(hoods, model, labels0, mu0, sigma0, **kw) -> RefResult:
    return _em_generic(hoods, model, labels0, mu0, sigma0, mode="coarse", **kw)


def golden_em(
    hoods: Hoods,
    model: EnergyModel,
    labels0,
    mu0,
    sigma0,
    *,
    max_em_iters: int = 20,
    max_map_iters: int = 10,
) -> RefResult:
    """The golden-oracle EM: a float32 NumPy transcription of the K-ary
    static-mode driver (DESIGN.md §13).

    Bit-parity design (what makes ``run_em``'s labels reproducible here):

    * all state and arithmetic are float32, never float64 — the trajectory
      (argmins, votes, convergence windows) follows the engine's precision;
    * keyed reductions accumulate in **element order** via ``np.add.at``,
      which matches XLA:CPU's sequential scatter-add order, so per-hood
      float energy sums agree bitwise with ``jax.ops.segment_sum``;
    * counts and votes are integer-valued (exact in any order), so argmin
      and plurality decisions are order-independent;
    * ``log`` is evaluated in float64 and rounded to float32 (correctly
      rounded), the closest a NumPy oracle can get to XLA's polynomial —
      a <=2-ulp energy jitter that discrete decisions absorb.

    ``tests/test_torch_reference.py`` holds it to the JAX package's copy;
    ``chip_smoke.py``'s ``oracle`` line holds the port's solves on the card
    to it.
    """
    f32 = np.float32
    vertex = _np(hoods.vertex)
    hood_id = _np(hoods.hood_id)
    valid = _np(hoods.valid)
    nh, nr = hoods.n_hoods, hoods.n_regions
    y_all = _np(model.region_mean, f32)
    w_all = _np(model.region_weight, f32)
    beta = f32(_np(model.beta))
    sig_min = f32(_np(model.sigma_min))
    reseed_mu = _np(model.reseed_mu, f32)
    reseed_sigma = f32(_np(model.reseed_sigma))
    K = int(_np(mu0).shape[0])

    labels = _np(labels0, np.int32).copy()
    mu = _np(mu0, f32).copy()
    sigma = _np(sigma0, f32).copy()

    validf = valid.astype(f32)
    y = y_all[vertex]
    w = w_all[vertex] * validf
    seg_h = np.where(valid, hood_id, nh)
    nall = np.zeros(nh + 1, f32)
    np.add.at(nall, seg_h, validf)
    nall_e = nall[hood_id]
    denom = np.maximum(nall_e - f32(1.0), f32(1.0))

    t0 = time.perf_counter()
    em_iters = 0
    map_total = 0
    hood_e = np.zeros(nh, f32)
    total_hist = np.zeros(WINDOW + 1, f32)

    for _em in range(max_em_iters):
        em_iters += 1
        hist = np.zeros((WINDOW + 1, nh), f32)

        for it in range(max_map_iters):
            map_total += 1
            x = labels[vertex]
            sig = np.maximum(sigma, sig_min)
            logsig = np.log(sig.astype(np.float64)).astype(f32)
            cnt = np.zeros((nh + 1) * K, f32)
            np.add.at(cnt, seg_h * K + x, validf)
            cnt = cnt.reshape(nh + 1, K)
            es = []
            for l in range(K):
                d = y - mu[l]
                data = w * (d * d / (f32(2.0) * sig[l] * sig[l]) + logsig[l])
                eq = (x == l).astype(f32)
                diff = (nall_e - cnt[hood_id, l]) - (f32(1.0) - eq)
                es.append(
                    data + beta * np.maximum(diff, f32(0.0)) / denom * validf
                )
            energies = np.stack(es)
            min_e = energies.min(axis=0)
            arg = energies.argmin(axis=0).astype(np.int32)

            he = np.zeros(nh + 1, f32)
            np.add.at(he, seg_h, np.where(valid, min_e, f32(0.0)))
            hood_e = he[:nh]
            votes = np.zeros((nr + 1) * K, f32)
            np.add.at(votes, vertex * K + np.where(valid, arg, 0), validf)
            labels = votes.reshape(nr + 1, K).argmax(axis=1).astype(np.int32)
            labels[nr] = 0

            hist = np.roll(hist, 1, axis=0)
            hist[0] = hood_e
            if it + 1 > WINDOW:
                deltas = np.abs(hist[:-1] - hist[1:])
                scale = np.maximum(np.abs(hist[0]), f32(1.0))
                if (deltas < f32(CONV_TOL) * scale).all():
                    break

        # M-step (static-mode segment reduction by label, float32)
        sw = np.zeros(K, f32)
        swy = np.zeros(K, f32)
        swyy = np.zeros(K, f32)
        np.add.at(sw, labels, w_all)
        np.add.at(swy, labels, w_all * y_all)
        np.add.at(swyy, labels, w_all * y_all * y_all)
        safe = np.maximum(sw, f32(1e-6))
        mu_n = swy / safe
        # XLA:CPU contracts `swyy/safe - mu*mu` into an FMA (one rounding);
        # emulate it exactly: f32 operands are exact in f64, the f64
        # product and difference are exact, one rounding back to f32.
        var_fma = (
            (swyy / safe).astype(np.float64)
            - mu_n.astype(np.float64) * mu_n.astype(np.float64)
        ).astype(f32)
        var = np.maximum(var_fma, f32(0.0))
        sigma_n = np.maximum(np.sqrt(var), sig_min)
        dead = sw < f32(1e-3) * sw.sum(dtype=f32)
        mu = np.where(dead, reseed_mu, mu_n).astype(f32)
        sigma = np.where(dead, reseed_sigma, sigma_n).astype(f32)

        total = hood_e.sum(dtype=f32)
        total_hist = np.roll(total_hist, 1)
        total_hist[0] = total
        if _em + 1 > WINDOW:
            deltas = np.abs(total_hist[:-1] - total_hist[1:])
            scale = np.maximum(np.abs(total_hist[0]), f32(1.0))
            if (deltas < f32(CONV_TOL) * scale).all():
                break

    return RefResult(
        labels=labels,
        mu=mu,
        sigma=sigma,
        em_iters=em_iters,
        map_iters=map_total,
        total_energy=float(hood_e.sum(dtype=np.float64)),
        seconds=time.perf_counter() - t0,
    )
