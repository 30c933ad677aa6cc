"""The port's EM driver (``repro_torch.core.pmrf.em.run_em``, static-pallas,
plain path on the CPU) against the JAX package's
``run_em(..., EMConfig(mode="static-pallas", backend="xla"))``.

The three problems are those of ``tests/test_golden.py`` (48x48; K = 2, 3,
5, quantile init), built by the JAX package and carried across with
``problem_from_numpy``; a fourth solves the three-phase image with K = 9
labels, the K the CUDA tick takes through its runtime-K variant.  Tolerances: labels, ``em_iters``, ``map_iters``
and ``status`` exact; ``mu``, ``sigma`` and ``total_energy`` within rtol
1e-5 (``sqrt`` and the closing sums may round differently in the last
bit).  bf16 is held to the JAX bf16 run by the drift tier of
``tests/test_golden.py``.

The port is also held to the live NumPy oracle ``reference.golden_em``,
not to the fixture files under ``tests/golden/``: with the installed JAX
those files no longer match the oracle (``test_fixture_matches_oracle``
fails on them), while the JAX ``run_em`` matches the live oracle.
"""

import numpy as np
import pytest

from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import em as jax_em
from repro.core.pmrf import pipeline as jax_pipeline
from repro.core.pmrf import reference

from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em

CASES = {
    2: dict(seed=0, shape=(48, 48), grid=(6, 6)),
    3: dict(seed=0, shape=(48, 48), grid=(6, 6)),
    5: dict(seed=1, shape=(48, 48), grid=(7, 7)),
    9: dict(seed=0, shape=(48, 48), grid=(7, 7), phases=3),
}
GOLDEN = (2, 3, 5)  # the problems of tests/test_golden.py
MAX_EM, MAX_MAP = 20, 10

_cache = {}


def _jax_problem(n_labels):
    if n_labels not in _cache:
        spec = CASES[n_labels]
        if n_labels == 2:
            vol = jax_synthetic.make_synthetic_volume(seed=spec["seed"], n_slices=1, shape=spec["shape"])
        else:
            vol = jax_synthetic.make_kary_volume(
                seed=spec["seed"], n_slices=1, shape=spec["shape"],
                n_phases=spec.get("phases", n_labels),
            )
        prob = jax_pipeline.initialize(
            np.asarray(vol.images[0]), overseg_grid=spec["grid"], n_labels=n_labels
        )
        init = jax_em.quantile_init(prob.graph.region_mean, prob.graph.n_regions, n_labels)
        _cache[n_labels] = (prob, tuple(np.asarray(a) for a in init))
    return _cache[n_labels]


def _carried_across(n_labels):
    prob, (labels0, mu0, sigma0) = _jax_problem(n_labels)
    d = {f: np.asarray(getattr(prob.hoods, f)) for f in convert.HOODS_ARRAYS}
    d.update({f: getattr(prob.hoods, f) for f in convert.HOODS_SIZES})
    d.update({f: np.asarray(getattr(prob.model, f)) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    return convert.problem_from_numpy(d, device="cpu")


def _run_both(n_labels, precision):
    prob, (labels0, mu0, sigma0) = _jax_problem(n_labels)
    want = jax_em.run_em(
        prob.hoods, prob.model, labels0, mu0, sigma0,
        jax_em.EMConfig(mode="static-pallas", backend="xla", precision=precision,
                        max_em_iters=MAX_EM, max_map_iters=MAX_MAP),
    )
    got = torch_em.run_em(
        *_carried_across(n_labels),
        torch_em.EMConfig(mode="static-pallas", precision=precision,
                          max_em_iters=MAX_EM, max_map_iters=MAX_MAP),
    )
    return want, got


@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_run_em_matches_jax(n_labels):
    want, got = _run_both(n_labels, "f32")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.em_iters == int(want.em_iters)
    assert got.map_iters == int(want.map_iters)
    assert got.status == int(want.status) == torch_em.STATUS_CONVERGED
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-5)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma), rtol=1e-5)
    np.testing.assert_allclose(float(got.total_energy), float(want.total_energy), rtol=1e-5)
    np.testing.assert_allclose(got.hood_energy.numpy(), np.asarray(want.hood_energy), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_labels", GOLDEN)
def test_run_em_matches_live_golden_oracle(n_labels):
    prob, (labels0, mu0, sigma0) = _jax_problem(n_labels)
    oracle = reference.golden_em(
        prob.hoods, prob.model, labels0, mu0, sigma0,
        max_em_iters=MAX_EM, max_map_iters=MAX_MAP,
    )
    got = torch_em.run_em(
        *_carried_across(n_labels),
        torch_em.EMConfig(max_em_iters=MAX_EM, max_map_iters=MAX_MAP),
    )
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(oracle.labels))
    assert got.em_iters == int(oracle.em_iters)
    assert got.map_iters == int(oracle.map_iters)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(oracle.mu), rtol=1e-5)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(oracle.sigma), rtol=1e-5)
    np.testing.assert_allclose(float(got.total_energy), float(oracle.total_energy), rtol=1e-4)


@pytest.mark.parametrize("n_labels", GOLDEN)
def test_run_em_bf16_drift_tier(n_labels):
    want, got = _run_both(n_labels, "bf16")
    agree = float(np.mean(got.labels.numpy() == np.asarray(want.labels)))
    assert agree >= 0.95, f"label agreement {agree:.4f}"
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=0.02)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma), rtol=0.02)
    np.testing.assert_allclose(float(got.total_energy), float(want.total_energy), rtol=0.02)
    assert got.status in (torch_em.STATUS_CONVERGED, torch_em.STATUS_MAX_ITERS)


def test_unported_modes_and_bad_settings_raise():
    problem = _carried_across(2)
    for mode in ("static", "faithful"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            torch_em.run_em(*problem, torch_em.EMConfig(mode=mode))
    with pytest.raises(ValueError, match="precision"):
        torch_em.run_em(*problem, torch_em.EMConfig(precision="fp8"))
    with pytest.raises(ValueError, match="backend"):
        torch_em.run_em(*problem, torch_em.EMConfig(backend="xla"))
    with pytest.raises(KeyError, match="labels0"):
        convert.problem_from_numpy({}, device="cpu")


def test_iteration_caps_and_status():
    """Stopping at the EM cap reports max_iters; the MAP cap bounds the
    inner loop; the result keeps its shapes."""
    problem = _carried_across(3)
    res = torch_em.run_em(*problem, torch_em.EMConfig(max_em_iters=2, max_map_iters=3))
    assert res.em_iters == 2 and res.map_iters <= 6
    assert res.status == torch_em.STATUS_MAX_ITERS
    assert res.labels.shape == problem.labels0.shape and res.mu.shape == (3,)
    prob, (labels0, mu0, sigma0) = _jax_problem(3)
    want = jax_em.run_em(
        prob.hoods, prob.model, labels0, mu0, sigma0,
        jax_em.EMConfig(mode="static-pallas", backend="xla", max_em_iters=2, max_map_iters=3),
    )
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(want.labels))
    assert (res.em_iters, res.map_iters, res.status) == (
        int(want.em_iters), int(want.map_iters), int(want.status),
    )
