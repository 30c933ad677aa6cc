"""The port's continuous-batching engine (``repro_torch.serving``) on the
CPU: the counterparts of ``tests/test_serve_engine.py``.

Every request served through ``SegmentationEngine`` (tick sizes 1, 3 and
``"auto"``, pools of 2 and 3 slots, more requests than slots) equals its
serial ``Segmenter.execute`` bit for bit (labels, segmentation, mu,
sigma, total energy, em/map iterations, status), on a stream whose
requests converge at different iterations (asserted), and equals the JAX
engine's completion of the same image (``ExecutionConfig(mode=
"static-pallas", backend="xla")``, run once per module): labels,
iterations and status exactly, mu, sigma and energy within rtol/atol 1e-5.

A live pool whose kernel route keeps failing switches to the plain route
under ``FallbackPolicy(backend="torch")``, as the reference's engine moves
its pool to its fallback backend: one event in the reference's keys, one
``RuntimeWarning``, one plain pool built, and every completion still bit
for bit its serial ``execute`` and the JAX engine's, for a fault before a
tick's first micro-step and one after it, at a fixed tick and partway up
an adaptive ladder, and at K = 3.  On the CPU both routes are the plain
versions: the tests label the session's route ``"cuda"`` (a
``monkeypatch`` of ``ExecutionConfig.resolved_backend``) and the chaos
harness or a failing micro-step fails it; the pool's state is still
carried onto the other route's pool workspace and the tick replayed
there.  The default policy, an engine already on the plain route and a
CUDA error raise ``FallbackError`` and build no plain pool.

The reference counts traces; the port's counterpart is that no workspace
is built once the pool is up (``kernels.ops.WORKSPACE_BUILDS``), across
admissions, retirements and tick-size switches.  The adaptive policy's
test gives the engine a fixed cost model, so it never depends on the
wall clock.  Images: 44x44 slices of the JAX package's synthetic volumes
(numpy pixels), grid 6, quantile init, planned by the port; the JAX
engine serves plans that carry the same arrays (``_jax_plan``: planning
these slices in the JAX package takes about a minute on the CPU).
"""

import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods
from repro.core.pmrf import pipeline as jax_pipeline
from repro.serving import SegmentationEngine as JaxEngine

from repro_torch import api
from repro_torch.core.pmrf import convert
from repro_torch.core.pmrf import em as em_mod
from repro_torch.kernels import ops
from repro_torch.serving import SegmentationEngine
from repro_torch.testing import chaos
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

CFG = dict(overseg_grid=(6, 6), capacity_bucket=2048, init="quantile")
SEED, N_REQUESTS = 7, 5
_jax = {}


def _images(n=N_REQUESTS, seed=SEED):
    vol = jax_synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=(44, 44))
    return [np.asarray(im) for im in vol.images]


def _session(**overrides):
    return api.Segmenter(api.ExecutionConfig(**{**CFG, **overrides}), device="cpu")


def _jax_plan(sess, plan):
    """A JAX session's plan holding the port plan's arrays: hoods, model,
    the region means (the quantile init's input) and the label map."""
    prob = plan.problem
    hoods = jax_hoods.Hoods(
        **{f: jnp.asarray(getattr(prob.hoods, f).numpy()) for f in convert.HOODS_ARRAYS},
        **{f: getattr(prob.hoods, f) for f in convert.HOODS_SIZES})
    graph = SimpleNamespace(n_regions=prob.graph.n_regions,
                            region_mean=jnp.asarray(prob.graph.region_mean.numpy()))
    problem = jax_pipeline.Problem(graph=graph, cliques=None, hoods=hoods, labels_px=prob.labels_px,
                                   model=jax_energy.EnergyModel(*(jnp.asarray(t.numpy())
                                                                  for t in prob.model)))
    return jax_api.Plan(problem=problem, bucket=sess.bucket_of(hoods), init_seconds=0.0)


def _jax_completions():
    """The JAX engine's completions of the module's stream, by rid."""
    if not _jax:
        sess = jax_api.Segmenter(jax_api.ExecutionConfig(mode="static-pallas", backend="xla", **CFG))
        engine = JaxEngine(sess, max_batch=2, tick_iters=3)
        port = _session()
        for rid, img in enumerate(_images()):
            engine.submit(_jax_plan(sess, port.plan(img)), rid=rid, seed=0)
        _jax.update({c.rid: c for c in engine.run()})
    return _jax


def _assert_matches_serial(completion, want):
    got = completion.result
    for f in ("region_labels", "segmentation", "mu", "sigma"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.em_iters, got.map_iters, got.status, got.total_energy) == (
        want.em_iters, want.map_iters, want.status, want.total_energy)
    assert completion.status == want.status


def _assert_matches_jax(completion, want):
    got, ref = completion.result, want.result
    np.testing.assert_array_equal(got.region_labels, ref.region_labels)
    np.testing.assert_array_equal(got.segmentation, ref.segmentation)
    assert (got.em_iters, got.map_iters, got.status) == (ref.em_iters, ref.map_iters, ref.status)
    assert completion.status == want.status
    for f in ("mu", "sigma", "total_energy"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=1e-5, atol=1e-5, err_msg=f)


def _serve(sess, plans, **engine_kw):
    engine = SegmentationEngine(sess, **engine_kw)
    for rid, plan in enumerate(plans):
        engine.submit(plan, rid=rid, seed=0)
    return engine, engine.run()


@pytest.mark.parametrize("max_batch", [2, 3])
@pytest.mark.parametrize("tick_iters", [1, 3, "auto"])
def test_engine_bit_identical_to_serial_and_matches_jax(tick_iters, max_batch):
    sess = _session()
    plans = [sess.plan(img) for img in _images()]
    serial = [sess.execute(p, seed=0) for p in plans]
    assert len({r.em_iters for r in serial}) > 1, "premise: mixed convergence"
    engine, completions = _serve(sess, plans, max_batch=max_batch, tick_iters=tick_iters)
    assert sorted(c.rid for c in completions) == list(range(N_REQUESTS))
    want = _jax_completions()
    for c in completions:
        _assert_matches_serial(c, serial[c.rid])
        _assert_matches_jax(c, want[c.rid])
    st = engine.stats()
    # More requests than slots: slots were refilled across ticks.
    assert st["admitted"] == N_REQUESTS and engine.ticks > 0 and st["occupancy"] > 0.5
    # Each lane paid its own MAP iterations: one pool launch per micro-step.
    assert st["lane_steps"] >= sum(r.map_iters for r in serial)
    assert st["total_steps"] < sum(r.map_iters for r in serial)


def test_admission_and_retirement_build_no_workspace():
    sess = _session()
    plans = [sess.plan(img) for img in _images()]
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
    for rid, plan in enumerate(plans):
        engine.submit(plan, rid=rid)
    engine.step()                      # brings the pool up and admits
    builds = ops.WORKSPACE_BUILDS
    completions = engine.run()
    assert ops.WORKSPACE_BUILDS == builds and len(completions) == len(plans)
    # A second engine on the session and bucket builds nothing either.
    engine2 = SegmentationEngine(sess, max_batch=2, tick_iters=3, bucket=engine.bucket)
    engine2.submit(plans[0], rid=0)
    (c,) = engine2.run()
    assert ops.WORKSPACE_BUILDS == builds
    _assert_matches_serial(c, sess.execute(plans[0], seed=0))


def test_run_em_ticked_driver_through_the_session():
    """No engine: one lane of a session's pool ticked to completion equals
    ``run_em`` on the lane's inputs, and the early exit issues exactly the
    lane's MAP iterations."""
    sess = _session()
    plan = sess.plan(_images(1)[0])
    h, m, l0, mu0, s0 = sess.lane_inputs(plan)
    cfg = sess.config.em_config()
    want = em_mod.run_em(h, m, l0, mu0, s0, cfg)
    exe = sess.compile_ticked(plan, batch=1, tick_iters=7)
    state = sess.ticked_pool(plan, batch=1)
    em_mod.init_tick_lane(state, 0, *sess.lane_state(plan))
    total = 0
    while not state.done[0]:
        state, steps = exe(state)
        assert 1 <= steps <= 7
        total += steps
    got = em_mod.tick_result(state, 0)
    assert total == got.map_iters == want.map_iters
    assert (got.labels.tolist(), got.mu.tolist(), got.sigma.tolist(), got.em_iters) == (
        want.labels.tolist(), want.mu.tolist(), want.sigma.tolist(), want.em_iters)


def test_adaptive_tick_sizes_share_one_pool():
    """``tick_iters="auto"`` with a fixed cost model (no wall clock): the
    ladder is compiled once at bring-up, one cache key per size at the
    pool's batch, all on one pool workspace; switches (forced by the cost
    model changing after three ticks) build nothing and keep every result
    bit for bit its serial run."""
    sess = _session()
    plans = [sess.plan(img) for img in _images()]
    serial = [sess.execute(p, seed=0) for p in plans]
    ladder = (1, 2, 4)
    engine = SegmentationEngine(sess, max_batch=2, tick_iters="auto", tick_ladder=ladder,
                                tick_hysteresis=1)
    # A large fixed cost first (large ticks pay), then a small one (small ticks).
    engine.cost_model = lambda: (1e-1, 1e-3) if engine.ticks < 3 else (1e-6, 1e-3)
    for rid, plan in enumerate(plans):
        engine.submit(plan, rid=rid, seed=0)
    engine.step()
    builds = ops.WORKSPACE_BUILDS
    completions = engine.run()
    assert ops.WORKSPACE_BUILDS == builds
    for c in completions:
        _assert_matches_serial(c, serial[c.rid])
    sizes = [to for _, _, to in engine.tick_switches]
    assert ladder[-1] in sizes and ladder[0] in sizes
    keys = [k for k in sess.cache_keys if k.tick_iters is not None and k.batch == 2]
    assert sorted(k.tick_iters for k in keys) == list(ladder)
    assert len({id(sess.compile_ticked(engine.bucket, batch=2, tick_iters=t).workspace)
                for t in ladder}) == 1
    st = engine.stats()
    assert st["adaptive"] and st["tick_switches"] == len(engine.tick_switches)
    assert sorted(st["tick_cost"]["per_size"]) == sorted(set(st["tick_cost"]["per_size"]))


def test_adaptive_policy_with_the_fit():
    """The fitted cost model: observations of a fixed cost plus a per-step
    cost give back those two numbers, floored at the host overhead, and the
    policy picks the ladder size that minimises the cost per useful step."""
    sess = _session()
    engine = SegmentationEngine(sess, max_batch=2, tick_iters="auto")
    assert engine.cost_model() == (5e-3, 5e-3)   # the prior, before any tick
    for t in (1, 2, 4, 8, 16, 8, 4):
        engine._cm.observe(t, 2e-3 + 1e-4 * t)
    a, b = engine.cost_model()
    assert a == pytest.approx(2e-3) and b == pytest.approx(1e-4)
    # S = 40 micro-steps and an empty queue (halved): argmin over the ladder.
    engine._steps_ewma = 40.0
    u = {t: (a + b * t) / (t * max(1 - t / 40.0, 0.25)) for t in engine.tick_ladder}
    assert engine._desired_tick_iters() == min(u, key=u.get)


def test_deadline_ordered_admission():
    sess = _session()
    plans = [sess.plan(img) for img in _images(3)]
    engine = SegmentationEngine(sess, max_batch=1, tick_iters=8)
    engine.submit(plans[0], rid=0, deadline_s=30.0)
    engine.submit(plans[1], rid=1)                  # no deadline: last
    engine.submit(plans[2], rid=2, deadline_s=1.0)  # tightest: first
    completions = engine.run()
    assert [c.rid for c in completions] == [2, 0, 1]
    for c in completions:
        assert c.latency_s == pytest.approx(c.queue_s + c.residence_s, abs=1e-3)
        assert c.ticks_resident >= 1


def test_admission_is_deterministic_with_all_none_deadlines():
    sess = _session()
    plans = [sess.plan(img) for img in _images(3)]
    for order in ([2, 0, 1], [1, 2, 0], [0, 1, 2]):
        engine = SegmentationEngine(sess, max_batch=1, tick_iters=8)
        for rid in order:
            engine.submit(plans[rid], rid=rid)
        assert [c.rid for c in engine.run()] == [0, 1, 2], order
    engine = SegmentationEngine(sess, max_batch=1, tick_iters=8)
    with pytest.raises(api.RequestError, match="rid must be an int"):
        engine.submit(plans[0], rid="abc")
    engine.submit(plans[0], rid=4)
    with pytest.raises(api.RequestError, match="already queued"):
        engine.submit(plans[1], rid=4)


def test_priority_classes_order_admission_before_deadlines():
    sess = _session()
    plans = [sess.plan(img) for img in _images(3)]
    engine = SegmentationEngine(sess, max_batch=1, tick_iters=8)
    engine.submit(plans[0], rid=0, priority=1, deadline_s=0.5)  # background
    engine.submit(plans[1], rid=1)                              # default
    engine.submit(plans[2], rid=2, priority=-1)                 # urgent
    assert [c.rid for c in engine.run()] == [2, 1, 0]


def test_mixed_k_requests_share_one_pool():
    """A K = 3 pool serves a K = 2 and a K = 3 request together: the K = 2
    lane is label-padded with an inert label and takes its own K's
    trajectory, equal bit for bit to a K = 2 session's serial result."""
    img2 = _images(1)[0]
    img3 = np.asarray(jax_synthetic.make_kary_volume(seed=5, n_slices=1, shape=(44, 44),
                                                     n_phases=3).images[0])
    sess2, sess3 = _session(), _session(n_labels=3)
    plan2, plan3 = sess2.plan(img2), sess3.plan(img3)
    want2, want3 = sess2.execute(plan2, seed=0), sess3.execute(plan3, seed=0)
    engine = SegmentationEngine(sess3, max_batch=2, tick_iters=4)
    engine.submit(plan2, rid=2, seed=0)
    engine.submit(plan3, rid=3, seed=0)
    got = {c.rid: c for c in engine.run()}
    g2 = got[2].result
    np.testing.assert_array_equal(g2.region_labels, want2.region_labels)
    np.testing.assert_array_equal(g2.segmentation, want2.segmentation)
    assert (g2.em_iters, g2.map_iters, g2.status) == (want2.em_iters, want2.map_iters, want2.status)
    np.testing.assert_array_equal(g2.mu[:2], want2.mu)
    np.testing.assert_array_equal(g2.sigma[:2], want2.sigma)
    assert g2.mu[2] == em_mod.INERT_MU
    _assert_matches_serial(got[3], want3)
    with pytest.raises(api.RequestError, match="wider pool"):
        SegmentationEngine(sess2, max_batch=1).submit(plan3)


def test_engine_rejects_oversized_and_sharded():
    sess = _session()
    plan = sess.plan(_images(1)[0])
    engine = SegmentationEngine(sess, max_batch=1, bucket=api.BucketKey(64, 8, 8))
    with pytest.raises(api.RequestError, match="exceeds the engine's fixed pool"):
        engine.submit(plan)
    assert engine.pending() == 0
    with pytest.raises(ValueError, match="single-device"):
        SegmentationEngine(api.ExecutionConfig(shards=2), device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        api.Segmenter(api.ExecutionConfig(shards=2), device="cpu").compile_ticked(
            api.BucketKey(64, 8, 8), batch=2)
    with pytest.raises(ValueError, match="tick_iters"):
        SegmentationEngine(sess, tick_iters="fast")
    with pytest.raises(RuntimeError, match="no bucket"):
        SegmentationEngine(sess)._ensure_pool()


NO_WAIT = dict(backoff_s=0.0, max_backoff_s=0.0)
TO_TORCH = api.FallbackPolicy(backend="torch", **NO_WAIT)


@pytest.fixture
def kernel_route(monkeypatch):
    """Label the session's route "cuda" where the config does not ask for
    the plain one (``tests/test_torch_fallback.py``'s fixture)."""
    monkeypatch.setattr(api.ExecutionConfig, "resolved_backend",
                        lambda self, device: "torch" if self.backend == "torch" else "cuda")


def _fail_micro_step(monkeypatch, workspace, at, error="allocator pressure"):
    """Make the ``at``-th micro-step (from now) on ``workspace``'s pool
    raise ``RuntimeError(error)`` before it steps; micro-steps on any other
    pool run as they are.  Returns the list of failures raised."""
    real, seen, raised = em_mod._tick_micro, [0], []

    def micro(state, config):
        if state.workspace is workspace:
            seen[0] += 1
            if seen[0] == at:
                raised.append(error)
                raise RuntimeError(error)
        return real(state, config)

    monkeypatch.setattr(em_mod, "_tick_micro", micro)
    return raised


def _started(sess, plans, **engine_kw):
    """An engine on ``sess`` with every request submitted and one tick run
    (the pool up, lanes resident on the session's route)."""
    engine = SegmentationEngine(sess, **engine_kw)
    for rid, plan in enumerate(plans):
        engine.submit(plan, rid=rid, seed=0)
    engine.step()
    assert engine.active() and engine._exe.key.backend == "cuda"
    return engine


def _run_switching(engine, fault_cfg=None):
    """The rest of the stream, every tick on the kernel route failing from
    now on (``fault_cfg``, by default ``exec_fail_backends=("cuda",)``):
    the completions by rid and the warnings' messages."""
    cfg = fault_cfg if fault_cfg is not None else chaos.ChaosConfig(exec_fail_backends=("cuda",))
    with chaos.inject(cfg), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        completions = engine.run()
    return {c.rid: c for c in completions}, [str(w.message) for w in caught
                                              if w.category is RuntimeWarning]


def _assert_switched(engine, sess, builds, messages):
    [event] = engine.fallback_events
    assert (event["stage"], event["from"], event["to"]) == ("tick", "cuda", "torch")
    assert set(event) == {"stage", "from", "to", "error"}
    assert engine.stats()["fallbacks"] == 1 and len(messages) == 1
    assert "switches to 'torch'" in messages[0]
    assert ops.WORKSPACE_BUILDS == builds + 1, "the plain pool, built once"
    assert engine._exe.key.backend == "torch" and engine._state.workspace.owner() is engine._state
    assert not sess.fallback_events


@pytest.mark.parametrize("fault", ["before_first_micro_step", "after_first_micro_step"])
def test_live_pool_switches_to_the_plain_route(fault, kernel_route, monkeypatch):
    """The kernel route fails from the second tick on: before a tick's
    first micro-step (the chaos harness's execute fault, retried once) or
    after it (a micro-step that raises once the tick has stepped the pool);
    the pool switches once, and every completion is bit for bit its serial
    ``execute`` and the JAX engine's."""
    sess = _session(fallback=TO_TORCH)
    plans = [sess.plan(img) for img in _images()]
    serial = [sess.execute(p, seed=0) for p in plans]
    engine = _started(sess, plans, max_batch=2, tick_iters=3)
    builds = ops.WORKSPACE_BUILDS
    if fault == "after_first_micro_step":
        raised = _fail_micro_step(monkeypatch, engine._state.workspace, at=2)
        comps, messages = _run_switching(engine, chaos.ChaosConfig())
        assert raised and engine.tick_retries == 0  # a tick that stepped is not replayed in place
        assert "allocator pressure" in engine.fallback_events[0]["error"]
    else:
        comps, messages = _run_switching(engine)
        assert engine.tick_retries == 1
    _assert_switched(engine, sess, builds, messages)
    want = _jax_completions()
    assert sorted(comps) == list(range(N_REQUESTS))
    for rid, c in comps.items():
        _assert_matches_serial(c, serial[rid])
        _assert_matches_jax(c, want[rid])


def test_adaptive_engine_switches_partway_up_its_ladder(kernel_route):
    """``tick_iters="auto"`` (the fixed cost model of
    ``test_adaptive_tick_sizes_share_one_pool``): the pool switches on its
    third tick, at a size between the ladder's ends; every size after it
    runs on the plain route (the kernel route keeps failing, and the pool
    never returns to it), every size is compiled there, and the
    completions equal serial ``execute`` and the JAX engine's."""
    sess = _session(fallback=TO_TORCH)
    plans = [sess.plan(img) for img in _images()]
    serial = [sess.execute(p, seed=0) for p in plans]
    ladder = (1, 2, 4)
    engine = _started(sess, plans, max_batch=2, tick_iters="auto", tick_ladder=ladder,
                      tick_hysteresis=1)
    engine.cost_model = lambda: (1e-1, 1e-3) if engine.ticks < 3 else (1e-6, 1e-3)
    engine.step()
    assert engine.tick_iters == ladder[-1] and engine.tick_switches
    builds = ops.WORKSPACE_BUILDS
    comps, messages = _run_switching(engine)
    _assert_switched(engine, sess, builds, messages)
    assert engine.tick_switches[-1][2] == ladder[0], "the ladder moved after the switch"
    assert sorted(k.tick_iters for k in sess.cache_keys
                  if k.backend == "torch" and k.batch == 2) == list(ladder)
    want = _jax_completions()
    for rid, c in comps.items():
        _assert_matches_serial(c, serial[rid])
        _assert_matches_jax(c, want[rid])


def test_live_pool_switch_at_k3(kernel_route, monkeypatch):
    """A K = 3 pool (three three-phase slices and a K = 2 request) switches
    after a tick's first micro-step; every completion equals its serial
    ``execute`` (the K = 2 request its own K's)."""
    imgs = [np.asarray(im) for im in jax_synthetic.make_kary_volume(
        seed=5, n_slices=3, shape=(44, 44), n_phases=3).images]
    sess3, sess2 = _session(n_labels=3, fallback=TO_TORCH), _session()
    plans = [sess3.plan(im) for im in imgs] + [sess2.plan(_images(1)[0])]
    serial = [sess3.execute(p, seed=0) for p in plans[:3]] + [sess2.execute(plans[3], seed=0)]
    engine = _started(sess3, plans, max_batch=2, tick_iters=4)
    builds = ops.WORKSPACE_BUILDS
    _fail_micro_step(monkeypatch, engine._state.workspace, at=3)
    comps, messages = _run_switching(engine, chaos.ChaosConfig())
    _assert_switched(engine, sess3, builds, messages)
    for rid in range(3):
        _assert_matches_serial(comps[rid], serial[rid])
    got, want = comps[3].result, serial[3]
    np.testing.assert_array_equal(got.region_labels, want.region_labels)
    np.testing.assert_array_equal(got.mu[:2], want.mu)
    np.testing.assert_array_equal(got.sigma[:2], want.sigma)
    assert (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters, want.status)


@pytest.mark.parametrize("case", ["default_policy", "already_plain", "cuda_error"])
def test_live_pool_that_does_not_switch(case, kernel_route, monkeypatch):
    """No switch, and ``FallbackError`` with the failure as its cause:
    under the default policy (the kernel route keeps failing), on an engine
    whose pool is already on the plain route, and on a CUDA error (which
    may have poisoned the context) under ``backend="torch"``.  No plain
    pool is built and no event is logged."""
    sess = _session(fallback=api.FallbackPolicy(**NO_WAIT) if case == "default_policy" else TO_TORCH,
                    **({"backend": "torch"} if case == "already_plain" else {}))
    plans = [sess.plan(img) for img in _images(3)]
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
    for rid, plan in enumerate(plans):
        engine.submit(plan, rid=rid, seed=0)
    engine.step()
    builds = ops.WORKSPACE_BUILDS
    fault = chaos.ChaosConfig(exec_fail_backends=(engine._exe.key.backend,))
    if case == "cuda_error":
        _fail_micro_step(monkeypatch, engine._state.workspace, at=1,
                         error="repro_em_tick_step_pool: CUDA error 700 (an illegal memory access)")
        fault = chaos.ChaosConfig()
    with chaos.inject(fault), pytest.raises(api.FallbackError) as err:
        engine.run()
    assert isinstance(err.value.__cause__, (chaos.ChaosError, RuntimeError))
    if case == "cuda_error":
        assert "CUDA error never switches" in str(err.value)
    assert not engine.fallback_events and engine.stats()["fallbacks"] == 0
    assert ops.WORKSPACE_BUILDS == builds
    assert [k.backend for k in sess.cache_keys if k.tick_iters] == [
        "torch" if case == "already_plain" else "cuda"]


def test_hood_ids_from_the_kernel_pools_offsets():
    """``em.hood_ids``: the plain pool's ``hood_id`` from the kernel pool's
    hood runs (``offsets``) and element mask, on the stream's plans as
    planned and padded into a pool's bucket, one lane and a stack."""
    sess = _session()
    plans = [sess.plan(img) for img in _images(3)]
    bucket = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
    hoods = [p.problem.hoods for p in plans] + [sess.lane_inputs(p, bucket=bucket)[0] for p in plans]
    for h in hoods:
        got = em_mod.hood_ids(h.offsets, h.valid, h.n_hoods)
        assert got.dtype == torch.int32 and torch.equal(got, h.hood_id)
    padded = hoods[len(plans):]
    stacked = em_mod.hood_ids(torch.stack([h.offsets for h in padded]),
                              torch.stack([h.valid.float() for h in padded]), bucket.n_hoods)
    assert torch.equal(stacked, torch.stack([h.hood_id for h in padded]))
