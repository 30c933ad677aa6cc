"""The modes ``static`` and ``faithful`` of the port (the paper's primitive
sequence, ``em.map_step``) against the JAX package, on the CPU.

The problems are 48x48 synthetic slices (K = 2, 3, 5; quantile init)
planned by the port on the CPU; the same numpy arrays (hoods, energy model,
initial parameters) go to both packages (``convert`` for the port, the JAX
dataclasses for the reference).  Each energy function of the modes is held
to its JAX counterpart on the same inputs; ``run_em`` in each mode to the
live JAX ``run_em`` of the same mode (``backend="xla"``) and to the live
NumPy oracle ``reference.golden_em``, never to ``tests/golden/*.npy``,
which are stale.  Then the two modes against each other, the session
around them and ``launch.segment --mode``.

Tolerances: labels, argmins, counts, votes, EM and MAP iteration counts
and status exact; energies, hood sums, mu and sigma within rtol 1e-5
(atol 1e-5): the modes sum in element order as JAX does on the CPU, but
``log`` and the fused M-step may round differently in the last bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods
from repro.core.pmrf import reference

from repro_torch import api
from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert, pipeline
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as torch_energy
from repro_torch.launch import segment as launch_segment
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

# K: (seed, size, grid)
CASES = {2: (0, 48, 6), 3: (0, 48, 6), 5: (1, 48, 7)}
MODES = ("static", "faithful")
MAX_EM, MAX_MAP = 20, 10
TOL = dict(rtol=1e-5, atol=1e-5)

_cache = {}


def _image(n_labels):
    seed, size, _ = CASES[n_labels]
    if n_labels == 2:
        vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size), device="cpu")
    else:
        vol = synthetic.make_kary_volume(seed=seed, n_slices=1, shape=(size, size),
                                         n_phases=n_labels, device="cpu")
    return vol.images[0].numpy()


def _arrays(n_labels):
    """The problem as numpy arrays: ``convert``'s keys."""
    if n_labels not in _cache:
        grid = CASES[n_labels][2]
        prob = pipeline.initialize(_image(n_labels), overseg_grid=(grid, grid), n_labels=n_labels,
                                   device="cpu")
        init = pipeline.initial_params(prob, 0, "quantile")
        d = {f: getattr(prob.hoods, f).numpy() for f in convert.HOODS_ARRAYS}
        d.update({f: getattr(prob.hoods, f) for f in convert.HOODS_SIZES})
        d.update({f: getattr(prob.model, f).numpy() for f in convert.MODEL_FIELDS})
        d.update(zip(convert.INIT_FIELDS, (t.numpy() for t in init)))
        _cache[n_labels] = d
    return _cache[n_labels]


def _jax_problem(n_labels):
    """``(hoods, model, (labels0, mu0, sigma0))`` of the JAX package."""
    d = _arrays(n_labels)
    hoods = jax_hoods.Hoods(**{k: jnp.asarray(d[k]) for k in convert.HOODS_ARRAYS},
                            **{k: d[k] for k in convert.HOODS_SIZES})
    model = jax_energy.EnergyModel(*(jnp.asarray(d[f]) for f in convert.MODEL_FIELDS))
    return hoods, model, tuple(d[k] for k in convert.INIT_FIELDS)


def _carried_across(n_labels):
    return convert.problem_from_numpy(_arrays(n_labels), device="cpu")


def _mid_state(n_labels):
    """A state inside a solve: the labels and parameters after one EM
    iteration of the JAX static mode, so the energies are not the init's."""
    jh, jm, (labels0, mu0, sigma0) = _jax_problem(n_labels)
    res = jax_em.run_em(jh, jm, labels0, mu0, sigma0,
                        jax_em.EMConfig(mode="static", backend="xla", max_em_iters=1,
                                        max_map_iters=2))
    return tuple(np.asarray(a) for a in (res.labels, res.mu, res.sigma * 1.3))


@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_energy_functions_match_jax(n_labels):
    jh, jm, _ = _jax_problem(n_labels)
    port = _carried_across(n_labels)
    h, m = port.hoods, port.model
    labels, mu, sigma = _mid_state(n_labels)
    lab, mu_t, sig_t = torch.from_numpy(labels), torch.from_numpy(mu), torch.from_numpy(sigma)

    counts, nall = torch_energy.hood_label_counts(h, lab, n_labels)
    jcounts, jnall = jax_energy.hood_label_counts(jh, labels, n_labels)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(nall.numpy(), np.asarray(jnall))

    energies = torch_energy.label_energies(h, m, lab, mu_t, sig_t)
    jenergies = jax_energy.label_energies(jh, jm, labels, mu, sigma)
    np.testing.assert_allclose(energies.numpy(), np.asarray(jenergies), **TOL)

    min_s, arg_s = torch_energy.min_energies_static(energies)
    jmin_s, jarg_s = jax_energy.min_energies_static(jenergies)
    np.testing.assert_allclose(min_s.numpy(), np.asarray(jmin_s), **TOL)
    np.testing.assert_array_equal(arg_s.numpy(), np.asarray(jarg_s))

    min_f, arg_f = torch_energy.min_energies_faithful(h, energies)
    jmin_f, jarg_f = jax_energy.min_energies_faithful(jh, jenergies)
    np.testing.assert_allclose(min_f.numpy(), np.asarray(jmin_f), **TOL)
    np.testing.assert_array_equal(arg_f.numpy(), np.asarray(jarg_f))
    # The sort and the segmented min give the axis-min's bits on valid lanes.
    valid = h.valid
    assert torch.equal(min_f[valid].view(torch.int32), min_s[valid].view(torch.int32))
    assert torch.equal(arg_f[valid], arg_s[valid])

    hood_e = torch_energy.hood_energy_sums(h, min_f)
    np.testing.assert_allclose(hood_e.numpy(), np.asarray(jax_energy.hood_energy_sums(jh, jmin_f)),
                               **TOL)

    new = torch_energy.vote_labels(h, arg_f, h.n_regions, n_labels)
    np.testing.assert_array_equal(
        new.numpy(), np.asarray(jax_energy.vote_labels(jh, jarg_f, jh.n_regions, n_labels)))

    for mode in MODES:
        got = torch_energy.update_parameters(m, lab, mode)
        want = jax_energy.update_parameters(jm, labels, mode)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_run_em_matches_jax(n_labels, mode):
    jh, jm, (labels0, mu0, sigma0) = _jax_problem(n_labels)
    want = jax_em.run_em(
        jh, jm, labels0, mu0, sigma0,
        jax_em.EMConfig(mode=mode, backend="xla", max_em_iters=MAX_EM, max_map_iters=MAX_MAP),
    )
    got = torch_em.run_em(*_carried_across(n_labels),
                          torch_em.EMConfig(mode=mode, max_em_iters=MAX_EM, max_map_iters=MAX_MAP))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.em_iters, got.map_iters, got.status) == (
        int(want.em_iters), int(want.map_iters), int(want.status))
    assert got.status in (torch_em.STATUS_CONVERGED, torch_em.STATUS_MAX_ITERS)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-5)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma), rtol=1e-5)
    np.testing.assert_allclose(got.hood_energy.numpy(), np.asarray(want.hood_energy), **TOL)


_oracle = {}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_run_em_matches_live_golden_oracle(n_labels, mode):
    jh, jm, (labels0, mu0, sigma0) = _jax_problem(n_labels)
    if n_labels not in _oracle:
        _oracle[n_labels] = reference.golden_em(
            jh, jm, labels0, mu0, sigma0,
            max_em_iters=MAX_EM, max_map_iters=MAX_MAP)
    oracle = _oracle[n_labels]
    got = torch_em.run_em(*_carried_across(n_labels),
                          torch_em.EMConfig(mode=mode, max_em_iters=MAX_EM, max_map_iters=MAX_MAP))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(oracle.labels))
    assert (got.em_iters, got.map_iters) == (int(oracle.em_iters), int(oracle.map_iters))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(oracle.mu), rtol=1e-5)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(oracle.sigma), rtol=1e-5)
    np.testing.assert_allclose(float(got.total_energy), float(oracle.total_energy), rtol=1e-4)


@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_faithful_and_static_modes_agree(n_labels):
    """The reference's ``test_faithful_and_static_modes_agree``: the sort
    and the segmented min give the axis-min's bits, so the two modes'
    solves are equal bit for bit (and equal the fused route's counts)."""
    problem = _carried_across(n_labels)
    cfg = torch_em.EMConfig(max_em_iters=MAX_EM, max_map_iters=MAX_MAP)
    res = {m: torch_em.run_em(*problem, cfg._replace(mode=m)) for m in MODES + ("static-pallas",)}
    s, f, p = res["static"], res["faithful"], res["static-pallas"]
    assert (s.em_iters, s.map_iters, s.status) == (f.em_iters, f.map_iters, f.status)
    assert (s.em_iters, s.map_iters, s.status) == (p.em_iters, p.map_iters, p.status)
    assert torch.equal(s.labels, f.labels) and torch.equal(s.labels, p.labels)
    for a, b in ((s.mu, f.mu), (s.sigma, f.sigma), (s.hood_energy, f.hood_energy)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_iteration_caps_and_max_map_zero():
    problem = _carried_across(3)
    for mode in MODES:
        res = torch_em.run_em(*problem, torch_em.EMConfig(mode=mode, max_em_iters=2, max_map_iters=3))
        assert res.em_iters == 2 and res.map_iters <= 6
        assert res.status == torch_em.STATUS_MAX_ITERS
        none = torch_em.run_em(*problem, torch_em.EMConfig(mode=mode, max_em_iters=2, max_map_iters=0))
        assert none.map_iters == 0 and torch.equal(none.labels, problem.labels0)
    with pytest.raises(ValueError, match="not a workspace"):
        torch_em.run_em(*problem, torch_em.EMConfig(mode="static"), workspace=object())


def test_batched_and_ticked_forms_raise():
    """The batched and ticked forms of the modes run (they raised
    ``NotImplementedError`` before they were ported): a two-lane stack
    through ``run_em_batched`` and a two-slot pool through
    ``run_em_ticked``, every lane its serial ``run_em`` bit for bit; a
    pool stepped under another mode raises ``ValueError``."""
    from repro_torch.core.pmrf.hoods import stack_hoods
    from repro_torch.kernels.ref import TickShape

    problem = _carried_across(2)
    stacked = stack_hoods([problem.hoods, problem.hoods])
    model = torch_energy.EnergyModel(*(torch.stack([f, f]) for f in problem.model))
    for mode in MODES:
        cfg = torch_em.EMConfig(mode=mode)
        want = torch_em.run_em(*problem, cfg)
        res = torch_em.run_em_batched(stacked, model, *(torch.stack([t, t]) for t in problem[2:]),
                                      cfg)
        ws = torch_em.make_workspace(TickShape.of(problem.hoods, problem.model), cfg,
                                     device="cpu", batch=2, pool=True)
        state = torch_em.blank_tick_state(ws)
        for slot in range(2):
            torch_em.init_tick_lane(state, slot, *problem)
        steps = 0
        while not all(state.done):
            steps += torch_em.run_em_ticked(state, cfg, 4)[1]
        assert steps == want.map_iters
        for got in [res.lane(b) for b in range(2)] + [torch_em.tick_result(state, b)
                                                      for b in range(2)]:
            assert (got.em_iters, got.map_iters, got.status) == (
                want.em_iters, want.map_iters, want.status)
            for f in ("labels", "mu", "sigma", "hood_energy", "total_energy"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f
        other = MODES[1 - MODES.index(mode)]
        with pytest.raises(ValueError, match="mode"):
            torch_em.run_em_ticked(state, cfg._replace(mode=other), 1)


def _session(mode, **kw):
    return api.Segmenter(api.ExecutionConfig(mode=mode, n_labels=2, overseg_grid=(6, 6),
                                             init="quantile", **kw), device="cpu")


def test_session_runs_the_modes():
    """``execute``, ``drain`` (one batched solve) and ``segment_stack`` in
    each mode equal the fused route's results; the batched and pooled
    executables build the mode's DPP workspaces; a warm execute builds
    nothing."""
    img = _image(2)
    ref = _session("static-pallas")
    plan = ref.plan(img)
    want = ref.execute(plan, seed=0)
    for mode in MODES:
        seg = _session(mode)
        p = seg.plan(img)
        got = seg.execute(p, seed=0)
        assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters, want.status)
        np.testing.assert_array_equal(got.region_labels, want.region_labels)
        exe = seg.compile(p)
        assert isinstance(exe.workspace, torch_em.DppBatchWorkspace) and exe.key.mode == mode
        assert exe.workspace.batch == 1
        seg.execute(p, seed=0)
        assert seg.stats.misses == 1 and seg.stats.hits >= 2
        seg.submit(p)
        seg.submit(p)
        drained = seg.drain()
        assert [r.map_iters for r in drained] == [want.map_iters] * 2
        stack, _ = seg.segment_stack([img, img], batch="never")
        auto, _ = seg.segment_stack([img, img], batch="auto")
        for r in stack + auto:
            np.testing.assert_array_equal(r.region_labels, want.region_labels)
        always, _ = seg.segment_stack([img, img], batch="always")
        for r in always:
            np.testing.assert_array_equal(r.region_labels, want.region_labels)
            assert (r.em_iters, r.map_iters, r.status) == (want.em_iters, want.map_iters,
                                                           want.status)
        assert isinstance(seg.compile(p, batch=2).workspace, torch_em.DppBatchWorkspace)
        ticked = seg.compile_ticked(p, batch=2)
        assert isinstance(ticked.workspace, torch_em.DppPoolWorkspace)
        pool = seg.ticked_pool(p, batch=2)
        assert pool.workspace is ticked.workspace and all(pool.done)


def test_launch_segment_mode_flag(capsys):
    args = ["--size", "40", "--grid", "5", "--labels", "3", "--slices", "2", "--device", "cpu"]
    rows = {m: launch_segment.main(args + ["--mode", m]) for m in MODES + ("static-pallas",)}
    for m in MODES:
        for got, want in zip(rows[m], rows["static-pallas"]):
            assert {k: got[k] for k in ("accuracy", "em_iters", "map_iters", "status")} == \
                   {k: want[k] for k in ("accuracy", "em_iters", "map_iters", "status")}
    out = capsys.readouterr().out
    assert '"mode": "faithful"' in out and '"mode": "static"' in out
