"""The port's batched EM (``em.run_em_batched``, the batched tick's plain
version ``ref.fused_map_iteration_batched``) on the CPU.

* Padding: ``hoods.pad_hoods`` (with the ``n_elements=-1`` the session
  passes), ``energy.pad_model``, ``pad_model_labels`` and
  ``pad_params_labels`` against the JAX package's, array for array.
* Every lane of ``run_em_batched`` against the JAX package's
  ``run_em_batched(EMConfig(mode="static-pallas", backend="xla"))`` on the
  same padded stack (slices of the JAX package's synthetic volumes, built
  by the JAX package and carried across with ``problem_from_numpy``, the
  quantile init): labels, ``em_iters``, ``map_iters`` and status exactly;
  mu, sigma and total energy within rtol/atol 1e-5.  bf16 lanes are held
  to the JAX bf16 run by the drift tier of ``tests/test_golden.py``.
* Every lane against the port's own serial ``run_em`` on that lane bit for
  bit, in stacks where lanes stop their MAP loops and finish their EM at
  different iterations.
* The plain batched step against one plain step per active lane, with the
  inactive lanes' rows untouched.

A test marked ``cuda`` holds the kernel's batched workspace to the plain
one on the card and skips without one.

The K = 9 stack's cases of the two solve tests are in
``tests/test_torch_batched_k9.py``, so that two test workers share the
JAX references: each stack's three JAX problems (planned by the JAX
package, a few hundred small compiles each) and its JAX solve cost as
much as the rest of this file's tests together.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods
from repro.core.pmrf import pipeline as jax_pipeline

from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf.hoods import pad_hoods, stack_hoods
from repro_torch.kernels import ops, ref
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

# K -> (phases, seed, grid): three 48x48 slices each.
STACKS = {2: (2, 4, 6), 3: (3, 4, 6), 9: (3, 0, 7)}
HERE = (2, 3)  # the stacks whose solves this file holds; K = 9's: test_torch_batched_k9.py
N_SLICES = 3
MAX_EM, MAX_MAP = 20, 10
_cache = {}


def _jax_stack(n_labels):
    """The JAX problems of one stack, padded to their joint bucket (the
    elementwise max, no rounding) and stacked as the reference's
    ``drain`` stacks them; returns (stacked, per-lane padded, joint)."""
    if n_labels in _cache:
        return _cache[n_labels]
    phases, seed, grid = STACKS[n_labels]
    if phases == 2:
        vol = jax_synthetic.make_synthetic_volume(seed=seed, n_slices=N_SLICES, shape=(48, 48))
    else:
        vol = jax_synthetic.make_kary_volume(seed=seed, n_slices=N_SLICES, shape=(48, 48),
                                             n_phases=phases)
    probs = [jax_pipeline.initialize(np.asarray(im), overseg_grid=(grid, grid), n_labels=n_labels)
             for im in vol.images]
    cap = max(p.hoods.capacity for p in probs)
    nh = max(p.hoods.n_hoods for p in probs)
    nr = max(p.hoods.n_regions for p in probs)
    lanes = []
    for p in probs:
        h = jax_hoods.pad_hoods(p.hoods, capacity=cap, n_hoods=nh, n_regions=nr, n_elements=-1)
        m = jax_energy.pad_model(p.model, nr)
        lab, mu, sig = jax_em.quantile_init(p.graph.region_mean, p.graph.n_regions, n_labels)
        lab0 = jnp.zeros((nr + 1,), jnp.int32).at[: p.graph.n_regions].set(lab[: p.graph.n_regions])
        lanes.append((p, h, m, lab0, mu, sig))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[ln[1:] for ln in lanes])
    _cache[n_labels] = (stacked, lanes, (cap, nh, nr))
    return _cache[n_labels]


def _lane_dict(h, m, lab0, mu, sig):
    d = {f: np.asarray(getattr(h, f)) for f in convert.HOODS_ARRAYS}
    d.update({f: getattr(h, f) for f in convert.HOODS_SIZES})
    d.update({f: np.asarray(getattr(m, f)) for f in convert.MODEL_FIELDS})
    d.update(labels0=np.asarray(lab0), mu0=np.asarray(mu), sigma0=np.asarray(sig))
    return d


def _torch_stack(n_labels):
    """The same padded stack carried across: ``(hoods, model, labels0,
    mu0, sigma0)`` with a leading lane axis, and the lanes."""
    _, lanes, _ = _jax_stack(n_labels)
    loaded = [convert.problem_from_numpy(_lane_dict(*ln[1:]), device="cpu") for ln in lanes]
    hoods = stack_hoods([p.hoods for p in loaded])
    model = E.EnergyModel(*(torch.stack(f) for f in zip(*(p.model for p in loaded))))
    rest = [torch.stack([p[j] for p in loaded]) for j in (2, 3, 4)]
    return (hoods, model, *rest), loaded


def _config(precision):
    return dict(mode="static-pallas", precision=precision, max_em_iters=MAX_EM,
                max_map_iters=MAX_MAP)


@pytest.mark.parametrize("n_labels", [2, 3])
def test_padding_matches_jax(n_labels):
    """``pad_hoods`` (``n_elements=-1``), ``pad_model`` and the label padding
    against the JAX package's on the same problems."""
    _, lanes, (cap, nh, nr) = _jax_stack(n_labels)
    for p, h_want, m_want, *_ in lanes:
        d = {f: np.asarray(getattr(p.hoods, f)) for f in convert.HOODS_ARRAYS}
        d.update({f: getattr(p.hoods, f) for f in convert.HOODS_SIZES})
        got = pad_hoods(convert.hoods_from_numpy(d, device="cpu"), capacity=cap, n_hoods=nh,
                        n_regions=nr, n_elements=-1)
        assert (got.n_hoods, got.n_regions, got.n_elements) == (nh, nr, -1)
        for f in convert.HOODS_ARRAYS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(h_want, f)), f)
        model = E.EnergyModel(*(torch.from_numpy(np.array(t, np.float32)) for t in p.model))
        got_m = E.pad_model(model, nr)
        for f in ("region_mean", "region_weight"):
            np.testing.assert_array_equal(getattr(got_m, f).numpy(), np.asarray(getattr(m_want, f)))
        wide = E.pad_model_labels(model, n_labels + 2)
        np.testing.assert_array_equal(
            wide.reseed_mu.numpy(), np.asarray(jax_energy.pad_model_labels(p.model, n_labels + 2).reseed_mu))
        mu, sig = (torch.arange(n_labels, dtype=torch.float32) + 1.0 for _ in range(2))
        got_p = E.pad_params_labels(mu, sig, n_labels + 2)
        want_p = jax_energy.pad_params_labels(jnp.asarray(mu.numpy()), jnp.asarray(sig.numpy()),
                                              n_labels + 2)
        for a, b in zip(got_p, want_p):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="shrink"):
        E.pad_model(model, 1)
    with pytest.raises(ValueError, match="shrink"):
        E.pad_params_labels(mu, sig, 1)


def test_stack_hoods_needs_one_bucket():
    (hoods, *_), loaded = _torch_stack(2)
    assert hoods.vertex.shape == (N_SLICES, hoods.capacity) and hoods.n_elements == -1
    other = pad_hoods(loaded[0].hoods, capacity=loaded[0].hoods.capacity + 1,
                      n_hoods=loaded[0].hoods.n_hoods, n_regions=loaded[0].hoods.n_regions)
    with pytest.raises(ValueError, match="different buckets"):
        stack_hoods([loaded[1].hoods, other])


@pytest.mark.parametrize("n_labels", HERE)
def test_run_em_batched_matches_jax(n_labels):
    check_run_em_batched_matches_jax(n_labels)


def check_run_em_batched_matches_jax(n_labels):
    """Every lane of the K stack's ``run_em_batched`` against the JAX
    package's (this docstring's tiers)."""
    stacked, _, _ = _jax_stack(n_labels)
    want = jax_em.run_em_batched(*stacked, jax_em.EMConfig(backend="xla", **_config("f32")))
    inputs, _ = _torch_stack(n_labels)
    got = torch_em.run_em_batched(*inputs, torch_em.EMConfig(**_config("f32")))
    for b in range(N_SLICES):
        what = f"K={n_labels} lane {b}"
        np.testing.assert_array_equal(got.labels[b].numpy(), np.asarray(want.labels[b]), what)
        assert (got.em_iters[b], got.map_iters[b], got.status[b]) == (
            int(want.em_iters[b]), int(want.map_iters[b]), int(want.status[b])), what
        for f in ("mu", "sigma", "total_energy", "hood_energy"):
            np.testing.assert_allclose(getattr(got, f)[b].numpy(), np.asarray(getattr(want, f)[b]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{what} {f}")
    assert got.steps >= max(got.map_iters)


def test_run_em_batched_bf16_drift_tier_vs_jax():
    stacked, _, _ = _jax_stack(2)
    want = jax_em.run_em_batched(*stacked, jax_em.EMConfig(backend="xla", **_config("bf16")))
    inputs, _ = _torch_stack(2)
    got = torch_em.run_em_batched(*inputs, torch_em.EMConfig(**_config("bf16")))
    for b in range(N_SLICES):
        agree = np.mean(got.labels[b].numpy() == np.asarray(want.labels[b]))
        assert agree >= 0.95
        np.testing.assert_allclose(got.mu[b].numpy(), np.asarray(want.mu[b]), rtol=0.02, atol=0.5)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_labels", HERE)
def test_every_lane_equals_its_serial_run(n_labels, precision):
    check_every_lane_equals_its_serial_run(n_labels, precision)


def check_every_lane_equals_its_serial_run(n_labels, precision):
    """Each lane bit for bit the serial ``run_em`` of its problem; the stack
    has lanes whose MAP loops stop before others' and whose EM finishes
    first, so the lockstep freezes them as the reference's vmap does."""
    inputs, loaded = _torch_stack(n_labels)
    config = torch_em.EMConfig(**_config(precision))
    got = torch_em.run_em_batched(*inputs, config)
    assert len(set(got.em_iters)) > 1 or len(set(got.map_iters)) > 1, "test premise: lanes part"
    assert got.steps < sum(got.map_iters)
    for b, p in enumerate(loaded):
        want = torch_em.run_em(*p, config)
        lane = got.lane(b)
        for f in ("labels", "mu", "sigma", "hood_energy", "total_energy"):
            a, c = getattr(lane, f), getattr(want, f)
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               c.view(torch.int32) if c.is_floating_point() else c), f"lane {b} {f}"
        assert (lane.em_iters, lane.map_iters, lane.status) == (want.em_iters, want.map_iters,
                                                               want.status)


def test_max_map_iters_zero_and_workspace_reuse():
    """No MAP iteration: every lane keeps its initial labels, as the serial
    driver does.  A workspace reused by a second solve gives the first
    solve's bits."""
    inputs, loaded = _torch_stack(3)
    cfg0 = torch_em.EMConfig(max_map_iters=0, max_em_iters=2)
    got = torch_em.run_em_batched(*inputs, cfg0)
    assert got.steps == 0
    for b, p in enumerate(loaded):
        want = torch_em.run_em(*p, cfg0)
        assert (got.em_iters[b], got.map_iters[b], got.status[b]) == (want.em_iters, 0, want.status)
        assert torch.equal(got.labels[b], want.labels)
    config = torch_em.EMConfig()
    ws = torch_em.make_workspace(ops.TickShape.of(inputs[0], inputs[1]), config, device="cpu",
                                 batch=N_SLICES)
    first = torch_em.run_em_batched(*inputs, config, workspace=ws)
    second = torch_em.run_em_batched(*inputs, config, workspace=ws)
    assert first.em_iters == second.em_iters and torch.equal(first.labels, second.labels)
    with pytest.raises(ValueError, match="lanes"):
        torch_em.run_em_batched(*inputs, config, workspace=torch_em.make_workspace(
            ws.shape, config, device="cpu", batch=N_SLICES + 1))
    with pytest.raises(ValueError, match="precision"):
        torch_em.run_em_batched(*inputs, config._replace(precision="bf16"), workspace=ws)


def test_batched_static_context_equals_per_lane():
    inputs, loaded = _torch_stack(3)
    got = E.make_static_context_batched(inputs[0], inputs[1])
    for b, p in enumerate(loaded):
        want = E.make_static_context(p.hoods, p.model)
        for f in want._fields:
            assert torch.equal(getattr(got, f)[b], getattr(want, f)), f


def _random_state(n_labels, batch, seed):
    rng = np.random.default_rng(seed)
    inputs, _ = _torch_stack(n_labels)
    hoods, model, labels0, mu0, sigma0 = inputs
    labels = torch.from_numpy(rng.integers(0, n_labels, labels0.shape).astype(np.int32))
    labels[:, -1] = 0
    mu = mu0 + torch.from_numpy(rng.normal(0.0, 3.0, mu0.shape).astype(np.float32))
    sig = torch.maximum(sigma0, model.sigma_min[:, None])
    ring = torch.from_numpy(rng.normal(0.0, 1.0, (batch, 4, hoods.n_hoods)).astype(np.float32))
    return inputs, labels, mu, sig, ring


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("cap", [False, True])
def test_plain_batched_step_equals_single_steps(precision, cap):
    """``fused_map_iteration_batched`` against ``fused_map_iteration`` on
    each active lane (lane 1 inactive): the active lanes' labels, votes,
    hood sums, ring rows and flags equal the single steps'; a lane that
    stops (its flag set, or ``cap``) takes the M-step sums and is retired;
    the inactive lane's rows stay as they were."""
    n_labels = 3
    (hoods, model, *_), labels, mu, sig, ring = _random_state(n_labels, N_SLICES, 7)
    sctx = E.make_static_context_batched(hoods, model)
    nh, nv = hoods.n_hoods, hoods.n_regions + 1
    votes = torch.full((N_SLICES, n_labels, nv), -1.0)
    hood_e = torch.full((N_SLICES, nh), -1.0)
    stats = torch.full((N_SLICES, 3, n_labels), -1.0)
    flags = torch.full((N_SLICES,), -1, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    state = [t.clone() for t in (labels, votes, hood_e, stats, flags, ring)]
    b_labels, b_votes, b_hood_e, b_stats, b_flags, b_ring = state
    ref.fused_map_iteration_batched(
        sctx.y, sctx.w, sctx.nall_e, sctx.validf, hoods.hood_id, hoods.vertex, model.region_mean,
        model.region_weight, b_ring, 2, b_labels, b_votes, b_hood_e, b_stats, b_flags, active,
        mu, sig, model.beta, gate=True, cap=cap, n_hoods=nh, n_vertices=nv, precision=precision)
    for b in range(N_SLICES):
        if b == 1:
            for new, old in zip(state, (labels, votes, hood_e, stats, flags, ring)):
                assert torch.equal(new[b], old[b])
            assert not active[b]
            continue
        one_ring = ring[b].clone()
        lab, he, v, flag, *sums = ref.fused_map_iteration(
            sctx.y[b], sctx.w[b], sctx.nall_e[b], sctx.validf[b], hoods.hood_id[b], hoods.vertex[b],
            model.region_mean[b], model.region_weight[b], one_ring, 2, labels[b], mu[b], sig[b],
            model.beta[b], gate=True, n_hoods=nh, n_vertices=nv, precision=precision)
        for a, c in ((b_labels[b], lab), (b_votes[b], v), (b_hood_e[b], he), (b_ring[b], one_ring),
                     (b_flags[b], flag)):
            assert torch.equal(a, c)
        stops = bool(int(flag)) or cap
        assert bool(active[b]) == (not stops)
        assert torch.equal(b_stats[b], torch.stack(sums) if stops else stats[b])


def test_plain_batch_workspace_follows_the_driver():
    """``ref.PlainBatchTickWorkspace`` as the batched driver uses it: lanes
    given to ``begin_em`` run, a lane that stops is retired, ``flags``
    reads every lane's word; it refuses a stack of another shape."""
    inputs, _ = _torch_stack(2)
    hoods, model, labels0, mu0, sigma0 = inputs
    shape = ops.TickShape.of(hoods, model)
    ws = ops.tick_workspace(shape, device="cpu", batch=N_SLICES)
    assert isinstance(ws, ref.PlainBatchTickWorkspace)
    sctx = E.make_static_context_batched(hoods, model)
    ws.start(hoods, model, sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels0)
    assert not ws.active.any()
    ws.begin_em(mu0, torch.maximum(sigma0, model.sigma_min[:, None]), [True, True, False])
    ws.step(False)
    assert ws.active.tolist() == [True, True, False] and len(ws.flags()) == N_SLICES
    assert torch.equal(ws.labels[2], labels0[2])
    ws.step(False, True)
    assert not ws.active.any()
    with pytest.raises(ValueError, match="built for"):
        ops.tick_workspace(shape._replace(n_hoods=shape.n_hoods + 1), device="cpu",
                           batch=N_SLICES).start(hoods, model, sctx.y, sctx.w, sctx.nall_e,
                                                 sctx.validf, labels0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", [2, 9])
def test_kernel_batched_solve_equals_plain_on_the_card(n_labels):
    """The card's batched tick against the plain batched path on the CPU
    over a whole stack solve: every lane's labels, counts and status."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)")
    inputs, _ = _torch_stack(n_labels)
    config = torch_em.EMConfig()
    want = torch_em.run_em_batched(*inputs, config)
    hoods, model, *rest = inputs
    import dataclasses

    card = (dataclasses.replace(hoods, **{f.name: getattr(hoods, f.name).cuda()
                                          for f in dataclasses.fields(hoods)
                                          if isinstance(getattr(hoods, f.name), torch.Tensor)}),
            E.EnergyModel(*(t.cuda() for t in model)), *(t.cuda() for t in rest))
    ops.reset_launch_counts()
    got = torch_em.run_em_batched(*card, config)
    assert ops.launch_counts()["fused_em_tick"] == got.steps
    assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters, want.status)
    assert torch.equal(got.labels.cpu(), want.labels)
