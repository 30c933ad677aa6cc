"""The port's ticked EM (``em.run_em_ticked``) and the plain version of the
tick's pool entry (``ref.PlainPoolTickWorkspace``) on the CPU.

* The plain pool step against one ``ref.fused_map_iteration`` per active
  lane, with the lanes at different MAP iterations (each its own ring head,
  gate and cap, ``ref.lane_controls``) and some lanes inactive, whose rows
  stay untouched; admitting into one slot leaves every other lane's
  buffers bit for bit as they were.
* ``run_em_ticked`` to completion on pools smaller than the stream (lanes
  admitted as slots free up) against the port's serial ``run_em`` on each
  lane bit for bit: labels, mu, sigma, hood energies, total energy,
  em/map iterations, status; a one-lane pool issues exactly its lane's MAP
  iterations (the early exit).
* Against the JAX package's ``run_em_ticked`` (``EMConfig(mode=
  "static-pallas", backend="xla")``) on the same padded problems (the
  port's arrays handed to the JAX package's ``Hoods`` and ``EnergyModel``
  as numpy): labels, iterations and status exactly, mu, sigma and energies
  within rtol/atol 1e-5 (the tiers of ``tests/test_torch_batched.py``).

Problems: three 48x48 slices of the JAX package's synthetic volumes (numpy
pixels), planned by the port on the CPU (grid 6, 7 at K = 9), quantile
init, padded to their joint bucket.  A test marked ``cuda`` holds the
kernel's pool to the plain one on the card.
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

from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf import pipeline
from repro_torch.core.pmrf.hoods import pad_hoods
from repro_torch.kernels import ops, ref
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

# K -> (phases, seed, grid): three 48x48 slices each.
STACKS = {2: (2, 4, 6), 3: (3, 4, 6), 9: (3, 0, 7)}
N_SLICES = 3
CONFIG = dict(mode="static-pallas", max_em_iters=20, max_map_iters=10)
_cache = {}


def _problems(n_labels):
    """The port's problems padded to their joint bucket with the quantile
    init (``convert.LoadedProblem``), and the same arrays as the JAX
    package's ``(hoods, model, labels0, mu0, sigma0)``."""
    if n_labels in _cache:
        return _cache[n_labels]
    phases, seed, grid = STACKS[n_labels]
    if phases == 2:
        vol = jax_synthetic.make_synthetic_volume(seed=seed, n_slices=N_SLICES, shape=(48, 48))
    else:
        vol = jax_synthetic.make_kary_volume(seed=seed, n_slices=N_SLICES, shape=(48, 48),
                                             n_phases=phases)
    probs = [pipeline.initialize(np.asarray(im), overseg_grid=(grid, grid), n_labels=n_labels,
                                 device="cpu") for im in vol.images]
    cap = max(p.hoods.capacity for p in probs)
    nh = max(p.hoods.n_hoods for p in probs)
    nr = max(p.hoods.n_regions for p in probs)
    jax_lanes, torch_lanes = [], []
    for p in probs:
        h = pad_hoods(p.hoods, capacity=cap, n_hoods=nh, n_regions=nr, n_elements=-1)
        m = E.pad_model(p.model, nr)
        lab, mu, sig = torch_em.quantile_init(p.graph.region_mean, p.graph.n_regions, n_labels)
        lab0 = torch.zeros((nr + 1,), dtype=torch.int32)
        lab0[: p.graph.n_regions] = lab[: p.graph.n_regions]
        torch_lanes.append(convert.LoadedProblem(h, m, lab0, mu, sig))
        jh = jax_hoods.Hoods(**{f: jnp.asarray(getattr(h, f).numpy()) for f in convert.HOODS_ARRAYS},
                             **{f: getattr(h, f) for f in convert.HOODS_SIZES})
        jm = jax_energy.EnergyModel(*(jnp.asarray(t.numpy()) for t in m))
        jax_lanes.append((jh, jm, *(jnp.asarray(t.numpy()) for t in (lab0, mu, sig))))
    _cache[n_labels] = (jax_lanes, torch_lanes)
    return _cache[n_labels]


def _pool(lanes, batch, precision="f32"):
    cfg = torch_em.EMConfig(precision=precision, **CONFIG)
    ws = torch_em.make_workspace(ops.TickShape.of(lanes[0].hoods, lanes[0].model), cfg,
                                 device="cpu", batch=batch, pool=True)
    return cfg, torch_em.blank_tick_state(ws)


def _serve(lanes, batch, tick_iters, precision="f32"):
    """Every lane through a pool of ``batch`` slots: admit into free slots,
    tick, read out done lanes.  Returns (results by lane, steps, ticks)."""
    cfg, state = _pool(lanes, batch, precision)
    queue, slots, results = list(range(len(lanes))), [None] * batch, {}
    steps = ticks = 0
    while queue or any(s is not None for s in slots):
        for b in range(batch):
            if slots[b] is None and queue:
                slots[b] = queue.pop(0)
                torch_em.init_tick_lane(state, b, *lanes[slots[b]])
        state, n = torch_em.run_em_ticked(state, cfg, tick_iters)
        assert 1 <= n <= tick_iters
        steps, ticks = steps + n, ticks + 1
        for b in range(batch):
            if slots[b] is not None and state.done[b]:
                results[slots[b]] = torch_em.tick_result(state, b)
                slots[b] = None
    return results, steps, ticks


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _assert_same(got, want, what):
    for f in ("labels", "mu", "sigma", "hood_energy", "total_energy"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f"{what} {f}"
    assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                       want.status), what


@pytest.mark.parametrize("n_labels", sorted(STACKS))
@pytest.mark.parametrize("batch, tick_iters", [(1, 4), (2, 1), (2, 3)])
def test_ticked_lanes_equal_their_serial_runs(n_labels, batch, tick_iters):
    _, lanes = _problems(n_labels)
    cfg = torch_em.EMConfig(**CONFIG)
    serial = [torch_em.run_em(*p, cfg) for p in lanes]
    got, steps, ticks = _serve(lanes, batch, tick_iters)
    for i, want in enumerate(serial):
        _assert_same(got[i], want, f"K={n_labels} lane {i}")
    # A pool runs each lane's own iterations: no launch waits for a slower lane.
    assert steps <= sum(r.map_iters for r in serial)
    assert steps >= -(-sum(r.map_iters for r in serial) // batch)
    if batch == 1:
        # The early exit: the pool issues exactly its lanes' MAP iterations.
        assert steps == sum(r.map_iters for r in serial)


def test_ticked_bf16_lanes_equal_their_serial_runs():
    _, lanes = _problems(2)
    cfg = torch_em.EMConfig(precision="bf16", **CONFIG)
    got, _, _ = _serve(lanes, 2, 3, precision="bf16")
    for i, p in enumerate(lanes):
        _assert_same(got[i], torch_em.run_em(*p, cfg), f"bf16 lane {i}")


def test_one_lane_pool_early_exit():
    """One lane ticked to completion with a tick larger than any MAP loop:
    the steps executed equal the lane's MAP iterations exactly."""
    _, lanes = _problems(2)
    cfg, state = _pool(lanes, 1)
    torch_em.init_tick_lane(state, 0, *lanes[0])
    total, ticks = 0, 0
    while not state.done[0]:
        state, n = torch_em.run_em_ticked(state, cfg, 7)
        total, ticks = total + n, ticks + 1
        assert ticks <= cfg.max_em_iters * cfg.max_map_iters
    got = torch_em.tick_result(state, 0)
    assert total == got.map_iters
    _assert_same(got, torch_em.run_em(*lanes[0], cfg), "one lane")


@pytest.mark.parametrize("n_labels", [2, 3])
def test_ticked_matches_jax_run_em_ticked(n_labels):
    jax_lanes, lanes = _problems(n_labels)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jax_lanes)
    hoods, model, lab0, mu0, sig0 = stacked
    nh, nr = jax_lanes[0][0].n_hoods, jax_lanes[0][0].n_regions
    state = jax.vmap(lambda l, m, s: jax_em.init_tick_lane(l, m, s, nh))(lab0, mu0, sig0)
    vplan = jax.vmap(lambda v: jax_em.make_vote_plan(v, nr))(hoods.vertex)
    cfg = jax_em.EMConfig(backend="xla", **CONFIG)
    while not bool(np.all(np.asarray(state.done))):
        state, _ = jax_em.run_em_ticked(hoods, model, state, vplan, cfg, 8)
    want = jax_em.tick_result(state)
    got, _, _ = _serve(lanes, 2, 3)
    for b in range(N_SLICES):
        what = f"K={n_labels} lane {b}"
        np.testing.assert_array_equal(got[b].labels.numpy(), np.asarray(want.labels[b]), what)
        assert (got[b].em_iters, got[b].map_iters, got[b].status) == (
            int(want.em_iters[b]), int(want.map_iters[b]), int(want.status[b])), what
        for f in ("mu", "sigma", "hood_energy", "total_energy"):
            np.testing.assert_allclose(getattr(got[b], f).numpy(), np.asarray(getattr(want, f)[b]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{what} {f}")


def _pool_state(ws):
    return {n: getattr(ws, n).clone() for n in ("labels", "votes", "hood_e", "ring", "stats",
                                                 "active", "map_i", "mu", "sigma", "y",
                                                 "region_mean")}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_plain_pool_step_equals_single_steps(precision):
    """Four slots: lanes 0, 2 and 3 at MAP iterations 0, 3 and 8 of a
    ``max_map_iters = 9`` loop (so lane 3 takes the cap bit), lane 1
    inactive.  After one step each active lane equals
    ``ref.fused_map_iteration`` from its own state with its own head, gate
    and cap; a lane that stops took its M-step sums and left the pool; the
    inactive lane's rows are untouched."""
    _, lanes = _problems(3)
    shape = ops.TickShape.of(lanes[0].hoods, lanes[0].model)
    ws = ops.tick_workspace(shape, device="cpu", batch=4, pool=True, max_map_iters=9,
                            precision=precision)
    assert isinstance(ws, ref.PlainPoolTickWorkspace)
    rng = np.random.default_rng(3)
    n_labels, nv, nh = shape.n_labels, shape.n_vertices, shape.n_hoods
    for b in range(4):
        h, m, lab0, mu0, sig0 = lanes[b % N_SLICES]
        s = E.make_static_context(h, m)
        ws.admit(b, h, m, s.y, s.w, s.nall_e, s.validf, lab0)
    for b, i in ((0, 0), (2, 3), (3, 8)):
        mu = lanes[b % N_SLICES].mu0 + torch.from_numpy(rng.normal(0, 3, n_labels).astype(np.float32))
        ws.begin_lanes([b], mu[None], torch.full((1, n_labels), 6.0))
        ws.map_i[b] = i
        ws.ring[b] = torch.from_numpy(rng.normal(0, 1, (4, nh)).astype(np.float32))
        ws.labels[b] = torch.from_numpy(rng.integers(0, n_labels, nv).astype(np.int32))
        ws.labels[b, -1] = 0
    ws.stats.fill_(-1.0)
    before = _pool_state(ws)
    ws.step()
    flags = ws.flags()
    after = _pool_state(ws)
    for name in before:
        assert torch.equal(after[name][1], before[name][1]), f"inactive lane's {name} written"
    for b, i in ((0, 0), (2, 3), (3, 8)):
        h = lanes[b % N_SLICES].hoods
        head, gate, cap = ref.lane_controls(i, 4, 9)
        assert (head, gate, cap) == ((-i) % 4, i + 1 > 3, i + 1 == 9)
        ring = before["ring"][b].clone()
        lab, he, v, flag, *sums = ref.fused_map_iteration(
            before["y"][b], ws.w[b], ws.nall[b], ws.valid[b], h.hood_id, h.vertex,
            before["region_mean"][b], ws.region_weight[b], ring, head, before["labels"][b],
            before["mu"][b], before["sigma"][b], ws.beta[b], gate=gate, n_hoods=nh,
            n_vertices=nv, precision=precision)
        for name, want in (("labels", lab), ("votes", v), ("hood_e", he), ("ring", ring)):
            assert torch.equal(after[name][b], want), f"lane {b} {name}"
        assert flags[b] == int(flag) and int(after["map_i"][b]) == i + 1
        stops = bool(int(flag)) or cap
        assert bool(after["active"][b]) == (not stops)
        want_stats = torch.stack(sums) if stops else before["stats"][b]
        assert torch.equal(after["stats"][b], want_stats), f"lane {b} stats"
    assert not after["active"][3], "the lane at its cap stops"


def test_admit_and_begin_touch_one_slot():
    """Slot writes (admit, begin_lanes, retire) leave every other lane's
    buffers bit for bit as they were."""
    _, lanes = _problems(2)
    cfg, state = _pool(lanes, 3)
    for b in range(2):
        torch_em.init_tick_lane(state, b, *lanes[b])
    state, _ = torch_em.run_em_ticked(state, cfg, 4)
    ws = state.workspace
    names = ("labels", "votes", "hood_e", "ring", "stats", "active", "map_i", "mu", "sigma",
             "y", "w", "nall", "valid", "hood_id", "vertex", "region_mean", "region_weight",
             "beta")
    before = {n: getattr(ws, n).clone() for n in names}
    torch_em.init_tick_lane(state, 2, *lanes[2])
    state.retire(2)
    state.hold(2, np.ones(2, np.float32))
    for n in names:
        for b in range(2):
            assert torch.equal(getattr(ws, n)[b], before[n][b]), f"lane {b} {n}"
    assert state.done[:2] == [False, False] and not state.done[2]


def test_run_em_ticked_refusals():
    _, lanes = _problems(2)
    cfg, state = _pool(lanes, 2)
    with pytest.raises(ValueError, match="tick_iters"):
        torch_em.run_em_ticked(state, cfg, 0)
    with pytest.raises(ValueError, match="max_map_iters"):
        torch_em.run_em_ticked(state, cfg._replace(max_map_iters=5), 2)
    with pytest.raises(ValueError, match="mode 'static-pallas'"):
        torch_em.run_em_ticked(state, cfg._replace(mode="static"), 2)
    # A new pool state on the same workspace takes it over.
    other = torch_em.blank_tick_state(state.workspace)
    with pytest.raises(ValueError, match="another TickState"):
        torch_em.run_em_ticked(state, cfg, 1)
    assert torch_em.run_em_ticked(other, cfg, 3) == (other, 0)  # an empty pool exits at once
    with pytest.raises(ValueError, match="batch"):
        ops.tick_workspace(ops.TickShape(256, 64, 65, 2), device="cpu", pool=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_labels", [2, 9])
def test_kernel_pool_equals_plain_on_the_card(n_labels):
    """The card's pool entry against the plain pool on the CPU over a whole
    stream: every lane's labels, counts and status, one launch per
    micro-step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (a CUDA kernel has no CPU mode)")
    import dataclasses

    _, lanes = _problems(n_labels)
    want, want_steps, _ = _serve(lanes, 2, 3)
    card = [convert.LoadedProblem(
        dataclasses.replace(p.hoods, **{f.name: getattr(p.hoods, f.name).cuda()
                                        for f in dataclasses.fields(p.hoods)
                                        if isinstance(getattr(p.hoods, f.name), torch.Tensor)}),
        E.EnergyModel(*(t.cuda() for t in p.model)), *(t.cuda() for t in p[2:])) for p in lanes]
    ops.reset_launch_counts()
    got, steps, _ = _serve(card, 2, 3)
    from repro_torch.kernels import em_tick

    assert em_tick.launches_pool == steps == want_steps
    for i in range(N_SLICES):
        assert (got[i].em_iters, got[i].map_iters, got[i].status) == (
            want[i].em_iters, want[i].map_iters, want[i].status)
        assert torch.equal(got[i].labels.cpu(), want[i].labels)
