"""The compiled programs of the modes ``static`` and ``faithful`` on the CPU
(their plain versions: the control structure of the card's CUDA graph run
by the host).

* ``em.run_em`` (one problem, a one-lane ``DppBatchWorkspace``),
  ``em.run_em_batched`` (a stack) and ``em.run_em_ticked`` (a pool's tick)
  against the JAX package's ``run_em``, ``run_em_batched`` and
  ``run_em_ticked`` (``backend="xla"``) on three 48x48 K = 2 slices
  padded to their joint bucket: labels, counts and status exact; mu, sigma
  and energies within rtol/atol 1e-5 (the tier of ``ROADMAP.md``).  Each
  mode's three JAX runs are made once, in a module-scoped fixture.
* Each program bit for bit the host-stepped driver it replaced
  (``testing.host_loop``): the solve and the stack at K = 2, 3 and 9, every
  lane its serial solve; a pool's ticks at tick sizes 1, 3 and 8 in pools
  of 2, 3 and 4 slots, the pool's state after every tick (lists, lane
  buffers, EM level) equal to the host-stepped tick's; a mixed-K engine
  stream (K = 2 requests in a K = 3 pool) equal through either tick.
* The step writes into fixed buffers: every buffer's ``data_ptr`` is the
  same after steps, EM boundaries, whole solves and ticks.
* A solve and a tick take one host read of their counters and no copy;
  inside their loops one read of the condition per iteration (on the card
  the graph's nodes read it) and no copy; switching tick sizes builds
  nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods

from repro_torch import api
from repro_torch.analysis import census
from repro_torch.core import synthetic
from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as E
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TickShape
from repro_torch.serving import SegmentationEngine
from repro_torch.testing import host_loop
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

MODES = ("static", "faithful")
MAX_EM, MAX_MAP = 20, 10
TOL = dict(rtol=1e-5, atol=1e-5)
# K -> (phases, seed, grid) of three 48x48 slices.
PROBLEMS = {2: (2, 6, 6), 3: (3, 4, 6), 9: (3, 0, 7)}
_cache = {}


def _session(mode, n_labels=2, **kw):
    grid = PROBLEMS[n_labels][2]
    return api.Segmenter(api.ExecutionConfig(mode=mode, n_labels=n_labels, overseg_grid=(grid, grid),
                                             init="quantile", max_em_iters=MAX_EM,
                                             max_map_iters=MAX_MAP, **kw), device="cpu")


def _images(n_labels, n=3):
    phases, seed, _ = PROBLEMS[n_labels]
    if phases == 2:
        return synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=(48, 48),
                                               device="cpu").images
    return synthetic.make_kary_volume(seed=seed, n_slices=n, shape=(48, 48), n_phases=phases,
                                      device="cpu").images


def _stack(n_labels):
    """``(stacked inputs, lanes)``: three slices padded to their joint
    bucket, stacked, and each lane's own inputs."""
    if n_labels not in _cache:
        seg = _session("static", n_labels)
        plans = [seg.plan(im) for im in _images(n_labels)]
        joint = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
        stacked = seg.stacked_inputs(plans, bucket=joint, seeds=[0] * len(plans))
        lanes = [seg.lane_inputs(p, bucket=joint, seed=0)[:5] for p in plans]
        _cache[n_labels] = (stacked, lanes)
    return _cache[n_labels]


def _config(mode):
    return torch_em.EMConfig(mode=mode, max_em_iters=MAX_EM, max_map_iters=MAX_MAP)


def _bits(t):
    return t.view(torch.int32) if t.is_floating_point() else t


def _assert_same(got, want, what):
    for f in ("labels", "mu", "sigma", "hood_energy", "total_energy"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f"{what} {f}"
    assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                       want.status), what


def _jax(inputs):
    hoods, model, lab0, mu0, sig0 = inputs
    jh = jax_hoods.Hoods(**{f: jnp.asarray(getattr(hoods, f).numpy()) for f in convert.HOODS_ARRAYS},
                         **{f: getattr(hoods, f) for f in convert.HOODS_SIZES})
    jm = jax_energy.EnergyModel(*(jnp.asarray(t.numpy()) for t in model))
    return (jh, jm, *(jnp.asarray(t.numpy()) for t in (lab0, mu0, sig0)))


def _pool(lanes, cfg, batch, tick_iters, ticked, record=None):
    """Every lane through a ``batch``-slot pool, each tick
    ``ticked(state, cfg, tick_iters)``; ``record(state)`` after each tick.
    Returns (results by lane, the pool's workspace)."""
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                 batch=batch, pool=True)
    state = torch_em.blank_tick_state(ws)
    queue, slots, results = list(range(len(lanes))), [None] * batch, {}
    while queue or any(s is not None for s in slots):
        for b in range(batch):
            if slots[b] is None and queue:
                slots[b] = queue.pop(0)
                torch_em.init_tick_lane(state, b, *lanes[slots[b]])
        state, _ = ticked(state, cfg, tick_iters)
        if record is not None:
            record(state)
        for b in range(batch):
            if slots[b] is not None and state.done[b]:
                results[slots[b]] = torch_em.tick_result(state, b)
                slots[b] = None
    return results, ws


def _snapshot(state):
    ws = state.workspace
    bufs = {n: getattr(ws, n).clone() for n in ("labels", "ring", "hood_e", "mu", "sigma",
                                                 "_stats", "active", "map_i", "em_mu",
                                                 "em_sigma", "total_hist")}
    return (list(state.em_i), list(state.map_i), list(state.map_total), list(state.done),
            list(state.status), state.micro_steps), bufs


@pytest.fixture(scope="module", params=MODES)
def jax_runs(request):
    """One mode's JAX ``run_em`` (lane 0), ``run_em_batched`` and
    ``run_em_ticked`` (every lane in its own slot, ticked to the end) of
    the K = 2 stack, each run once."""
    mode = request.param
    stacked, lanes = _stack(2)
    cfg = jax_em.EMConfig(mode=mode, backend="xla", max_em_iters=MAX_EM, max_map_iters=MAX_MAP)
    one = jax_em.run_em(*_jax(lanes[0]), cfg)
    hoods, model, lab0, mu0, sig0 = _jax(stacked)
    batched = jax_em.run_em_batched(hoods, model, lab0, mu0, sig0, cfg)
    state = jax.vmap(lambda l, m, s: jax_em.init_tick_lane(l, m, s, hoods.n_hoods))(lab0, mu0, sig0)
    vplan = jax.vmap(lambda v: jax_em.make_vote_plan(v, hoods.n_regions))(hoods.vertex)
    while not bool(np.all(np.asarray(state.done))):
        state, _ = jax_em.run_em_ticked(hoods, model, state, vplan, cfg, 8)
    return mode, one, batched, jax_em.tick_result(state)


def _close(got, want, b, what):
    """Lane ``b`` of the port's result against lane ``b`` of a JAX one (or
    the JAX result itself when ``b`` is None)."""
    pick = (lambda v: v) if b is None else (lambda v: v[b])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(pick(want.labels)), what)
    assert (got.em_iters, got.map_iters, got.status) == tuple(
        int(pick(getattr(want, f))) for f in ("em_iters", "map_iters", "status")), what
    for f in ("mu", "sigma", "hood_energy", "total_energy"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(pick(getattr(want, f))),
                                   err_msg=f"{what} {f}", **TOL)


def test_programs_match_jax(jax_runs):
    mode, one, batched, ticked = jax_runs
    stacked, lanes = _stack(2)
    cfg = _config(mode)
    _close(torch_em.run_em(*lanes[0], cfg), one, None, f"{mode} run_em")
    got = torch_em.run_em_batched(*stacked, cfg)
    assert len(set(got.map_iters)) > 1, "the stack's lanes stop at different iterations"
    for b in range(3):
        _close(got.lane(b), batched, b, f"{mode} run_em_batched lane {b}")
    served, _ = _pool(lanes, cfg, 3, 8, torch_em.run_em_ticked)
    for b in range(3):
        _close(served[b], ticked, b, f"{mode} run_em_ticked lane {b}")


@pytest.mark.parametrize("n_labels", [2, 3, 9])
@pytest.mark.parametrize("mode", MODES)
def test_solve_and_stack_equal_the_host_stepped_drivers(mode, n_labels):
    stacked, lanes = _stack(n_labels)
    cfg = _config(mode)
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu")
    assert isinstance(ws, torch_em.DppBatchWorkspace) and ws.batch == 1
    serial = []
    for b, lane in enumerate(lanes):
        got = torch_em.run_em(*lane, cfg, workspace=ws)
        _assert_same(got, host_loop.run_em(*lane, cfg), f"{mode} K={n_labels} solve {b}")
        serial.append(got)
    got = torch_em.run_em_batched(*stacked, cfg)
    want = host_loop.run_em_batched(*stacked, cfg)
    assert got.steps == want.steps
    for b in range(3):
        _assert_same(got.lane(b), want.lane(b), f"{mode} K={n_labels} stack lane {b}")
        _assert_same(got.lane(b), serial[b], f"{mode} K={n_labels} lane {b} vs serial")


@pytest.mark.parametrize("mode", MODES)
def test_iteration_limits_equal_the_host_stepped_drivers(mode):
    """The programs' edges: no MAP iteration (the M-step of the starting
    labels at every EM iteration), and EM and MAP caps that stop every
    lane."""
    stacked, lanes = _stack(2)
    for limits in (dict(max_em_iters=3, max_map_iters=0), dict(max_em_iters=2, max_map_iters=3),
                   dict(max_em_iters=0, max_map_iters=4)):
        cfg = _config(mode)._replace(**limits)
        _assert_same(torch_em.run_em(*lanes[1], cfg), host_loop.run_em(*lanes[1], cfg),
                     f"{mode} {limits}")
        got, want = torch_em.run_em_batched(*stacked, cfg), host_loop.run_em_batched(*stacked, cfg)
        for b in range(3):
            _assert_same(got.lane(b), want.lane(b), f"{mode} {limits} lane {b}")


@pytest.mark.parametrize("tick_iters,batch", [(1, 2), (3, 3), (8, 4)])
@pytest.mark.parametrize("mode", MODES)
def test_tick_equals_the_host_stepped_tick(mode, tick_iters, batch):
    """Two pools fed the same requests, one ticked by the program and one by
    the host-stepped tick: after every tick their states are equal (host
    lists, micro-steps, every lane buffer and the EM level), and every lane
    ends bit for bit its serial solve."""
    _, lanes = _stack(2)
    lanes = lanes + lanes[:2]
    cfg = _config(mode)
    seen = {"program": [], "host": []}
    got, _ = _pool(lanes, cfg, batch, tick_iters, torch_em.run_em_ticked,
                   lambda st: seen["program"].append(_snapshot(st)))
    want, _ = _pool(lanes, cfg, batch, tick_iters, host_loop.run_em_ticked,
                    lambda st: seen["host"].append(_snapshot(st)))
    assert len(seen["program"]) == len(seen["host"])
    for t, ((lists, bufs), (lists_h, bufs_h)) in enumerate(zip(seen["program"], seen["host"])):
        assert lists == lists_h, f"tick {t}"
        for n, v in bufs.items():
            assert torch.equal(_bits(v), _bits(bufs_h[n])), f"tick {t} {n}"
    for b, lane in enumerate(lanes):
        _assert_same(got[b], want[b], f"{mode} tick {tick_iters} lane {b}")
        _assert_same(got[b], torch_em.run_em(*lane, cfg), f"{mode} tick {tick_iters} serial {b}")


@pytest.mark.parametrize("mode", MODES)
def test_mixed_k_engine_equals_the_host_stepped_tick(mode, monkeypatch):
    """K = 2 and K = 3 requests in one K = 3 pool through the engine: the
    same completions whether the pool ticks by its program or by the
    host-stepped tick, and the K = 3 ones their serial execute."""
    sess2, sess3 = _session(mode), _session(mode, n_labels=3, capacity_bucket=1024)
    plans = ([sess2.plan(im) for im in _images(2, 2)]
             + [sess3.plan(im) for im in _images(3, 2)])

    def serve():
        engine = SegmentationEngine(sess3, max_batch=2, tick_iters=3)
        for rid, p in enumerate(plans):
            engine.submit(p, rid=rid, seed=0)
        return {c.rid: c.result for c in engine.run()}

    got = serve()
    monkeypatch.setattr(torch_em, "run_em_ticked", host_loop.run_em_ticked)
    want = serve()
    for rid in range(4):
        a, b = got[rid], want[rid]
        for f in ("region_labels", "mu", "sigma"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{rid} {f}")
        assert (a.em_iters, a.map_iters, a.status) == (b.em_iters, b.map_iters, b.status)
    for rid in (2, 3):
        want3 = sess3.execute(plans[rid], seed=0)
        np.testing.assert_array_equal(got[rid].region_labels, want3.region_labels)
        assert (got[rid].em_iters, got[rid].map_iters) == (want3.em_iters, want3.map_iters)


_BUFFERS = ("labels", "ring", "hood_e", "mu", "sigma", "_stats", "_stopped", "lane", "ctl", "tick",
            "active", "map_i", "_flags", "em_mu", "em_sigma", "total_hist", "mu0", "sigma0",
            "vertex", "hood_id", "valid", "region_mean", "region_weight")


def _ptrs(ws):
    return {n: getattr(ws, n).data_ptr() for n in _BUFFERS}


@pytest.mark.parametrize("mode", MODES)
def test_step_writes_into_fixed_buffers(mode):
    """The addresses a captured step reads and writes do not move: across
    host-stepped steps, M-steps and EM starts, across whole program solves,
    and across a pool's admissions and ticks (the TickState's tensors are
    the pool's own buffers)."""
    stacked, lanes = _stack(2)
    cfg = _config(mode)
    ws = torch_em.make_workspace(TickShape.of(stacked[0], stacked[1]), cfg, device="cpu", batch=3)
    ptrs = _ptrs(ws)
    host_loop.run_em_batched(*stacked, cfg, workspace=ws)
    assert _ptrs(ws) == ptrs
    torch_em.run_em_batched(*stacked, cfg, workspace=ws)
    torch_em.run_em_batched(*stacked, cfg._replace(max_map_iters=MAX_MAP), workspace=ws)
    assert _ptrs(ws) == ptrs
    pool = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                   batch=2, pool=True)
    ptrs = _ptrs(pool)
    state = torch_em.blank_tick_state(pool)
    assert state.mu is pool.em_mu and state.total_hist is pool.total_hist
    for b in range(2):
        torch_em.init_tick_lane(state, b, *lanes[b])
    for tick in (1, 3, 8):
        state, _ = torch_em.run_em_ticked(state, cfg, tick)
        assert _ptrs(pool) == ptrs, f"tick {tick}"
    state.hold(0, np.ones(2, np.float32))
    host_loop.run_em_ticked(state, cfg, 2)
    assert _ptrs(pool) == ptrs and state.mu is pool.em_mu


@pytest.mark.parametrize("mode", MODES)
def test_one_read_and_no_copy_per_call(mode):
    """The census of a warm solve and of a tick: one host read of the
    counters in the call's own scope and no host-to-device copy anywhere.
    In each loop iteration of the solve one read, the condition word that
    the graph's WHILE node reads on the card, and no device op outside the
    program's steps; in a tick's micro-steps no read at all (the plain
    tick runs them with the loop's condition as a mask)."""
    _, lanes = _stack(2)
    cfg = _config(mode)
    ws = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu")
    torch_em.run_em(*lanes[0], cfg, workspace=ws)
    with census.take() as cen:
        torch_em.run_em(*lanes[0], cfg, workspace=ws)
    pool = torch_em.make_workspace(TickShape.of(lanes[0][0], lanes[0][1]), cfg, device="cpu",
                                   batch=2, pool=True)
    state = torch_em.blank_tick_state(pool)
    for b in range(2):
        torch_em.init_tick_lane(state, b, *lanes[b])
    with census.take() as tick_cen:
        torch_em.run_em_ticked(state, cfg, 8)
    for what, s in (("solve", cen.summary()), ("tick", tick_cen.summary())):
        solve = s[census.SOLVE]
        assert solve["instances"] == 1, what
        assert solve["max"]["host_reads"] == 1 and solve["max"]["h2d_copies"] == 0, what
        for scope in (census.MAP_ITERATION, census.EM_BOUNDARY):
            reads = 1 if what == "solve" else 0
            assert s[scope]["instances"] > 0, f"{what} {scope}"
            assert s[scope]["max"]["host_reads"] == s[scope]["min"]["host_reads"] == reads, \
                f"{what} {scope}"
            assert s[scope]["max"]["h2d_copies"] == 0, f"{what} {scope}"
            if what == "solve":
                assert s[scope]["max"]["device_ops"] == 0, f"{what} {scope}"


@pytest.mark.parametrize("mode", MODES)
def test_session_builds_one_program_per_pool_whatever_the_tick(mode):
    """``Segmenter.compile`` builds a mode's solve workspace and program once
    (a hit builds nothing); a pool builds its program once and every tick
    size of the ladder replays it."""
    seg = _session(mode)
    plan = seg.plan(_images(2, 1)[0])
    builds, programs = ops.WORKSPACE_BUILDS, ops.PROGRAM_BUILDS
    seg.execute(plan, seed=0)
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (1, 1)
    seg.execute(plan, seed=0)
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (1, 1)
    exes = [seg.compile_ticked(plan, batch=2, tick_iters=t) for t in (1, 3, 8)]
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (2, 2)
    state = seg.ticked_pool(plan, batch=2)
    torch_em.init_tick_lane(state, 0, *seg.lane_inputs(plan, seed=0)[:5])
    for exe in exes * 2:
        state, _ = exe(state)
    assert (ops.WORKSPACE_BUILDS - builds, ops.PROGRAM_BUILDS - programs) == (2, 2)
    assert all(state.done)
