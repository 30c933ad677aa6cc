"""The port's chaos harness (``repro_torch.testing.chaos``) against the
serving engine on the CPU: the counterparts of ``tests/test_chaos.py``'s
request-fault tests.

Under every request fault the engine drains (never raises, never wedges):
a ``nan_image`` request is refused at ``submit`` with ``PlanError``; a
``bad_init`` or ``nan_data`` lane retires with the status its serial
``run_em`` on the same corrupted inputs reports (``diverged``); a
``never_converge`` lane is evicted when its residency budget runs out; and
every healthy co-resident lane is bit for bit the same stream served with
no chaos at all.  The harness draws what the JAX package's draws (the same
faults for the same rids, the same poisoned regions and pixels), and slow
ticks trip the straggler watchdog.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import synthetic as jax_synthetic
from repro.testing import chaos as jax_chaos

from repro_torch import api
from repro_torch.core.pmrf import em as em_mod
from repro_torch.serving import SegmentationEngine
from repro_torch.serving.engine import SegCompletion
from repro_torch.testing import chaos
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()


def _session():
    return api.Segmenter(api.ExecutionConfig(overseg_grid=(6, 6), capacity_bucket=2048,
                                             init="quantile"), device="cpu")


def _plans(sess, n=5, shape=(40, 40), seed=5):
    vol = jax_synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=shape)
    return [sess.plan(np.asarray(im)) for im in vol.images]


def _serve(sess, plans, faults=None, **engine_kw):
    """The stream through a fresh engine (2 slots, ticks of 4), under chaos
    when ``faults`` are given."""
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=4, **engine_kw)
    with chaos.inject(chaos.ChaosConfig(seed=7, **(faults or {}))):
        for rid, p in enumerate(plans):
            engine.submit(p, rid=rid, seed=0)
        comps = engine.run()
    return engine, {c.rid: c for c in comps}


def _same(a, b):
    for f in ("region_labels", "segmentation", "mu", "sigma"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.em_iters, a.map_iters, a.status, a.total_energy) == (
        b.em_iters, b.map_iters, b.status, b.total_energy)


def test_fault_assignment_matches_the_reference():
    cfg = dict(seed=3, bad_init_rate=0.3, nan_data_rate=0.3, never_converge_rids=(4,))
    ours = [chaos.ChaosMonkey(chaos.ChaosConfig(**cfg)).fault_for_request(r) for r in range(50)]
    again = [chaos.ChaosMonkey(chaos.ChaosConfig(**cfg)).fault_for_request(r) for r in range(50)]
    ref = [jax_chaos.ChaosMonkey(jax_chaos.ChaosConfig(**cfg)).fault_for_request(r) for r in range(50)]
    assert ours == again == ref
    assert set(ours) <= {None, "bad_init", "nan_data", "never_converge"}
    assert ours[4] == "never_converge" and ours.count("bad_init") and ours.count("nan_data")
    m, r = chaos.ChaosMonkey(chaos.ChaosConfig(seed=3)), jax_chaos.ChaosMonkey(jax_chaos.ChaosConfig(seed=3))
    np.testing.assert_array_equal(m.hold_perturbation(1, 2, 3), r.hold_perturbation(1, 2, 3))
    img = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(np.isnan(m.poison_image(img, 5)), np.isnan(r.poison_image(img, 5)))


def test_on_admit_corrupts_what_the_reference_corrupts():
    """``bad_init`` NaNs mu0, ``nan_data`` the reference's regions; the
    plan's own tensors are never written."""
    sess = _session()
    [plan] = _plans(sess, n=1)
    h, m, lab0, mu0, sig0 = sess.lane_inputs(plan)
    keep = m.region_mean.clone(), mu0.clone()
    cfg = dict(seed=7, bad_init_rids=(1,), nan_data_rids=(2,))
    ours, ref = chaos.ChaosMonkey(chaos.ChaosConfig(**cfg)), jax_chaos.ChaosMonkey(jax_chaos.ChaosConfig(**cfg))
    m1, _, mu1, _ = ours.on_admit(1, m, lab0, mu0, sig0)
    assert m1 is m and torch.isnan(mu1).all()
    m2, _, mu2, _ = ours.on_admit(2, m, lab0, mu0, sig0)
    assert mu2 is mu0
    jm = m._replace(region_mean=m.region_mean.numpy())
    want = ref.on_admit(2, jm, lab0.numpy(), mu0.numpy(), sig0.numpy())[0].region_mean
    np.testing.assert_array_equal(torch.isnan(m2.region_mean).numpy(), np.isnan(want))
    assert torch.equal(m.region_mean, keep[0]) and torch.equal(mu0, keep[1])
    assert [e["kind"] for e in ours.events] == ["bad_init", "nan_data"]


def test_hooks_are_noops_without_context():
    assert not chaos.is_active()
    model = object()
    assert chaos.on_admit(0, model, 1, 2, 3) == (model, 1, 2, 3)
    assert chaos.hold_lane(0) is False
    chaos.on_compile("torch")
    chaos.on_execute("torch")
    chaos.on_tick(0)


def test_inject_stacks_and_restores():
    with chaos.inject(chaos.ChaosConfig(seed=1)) as outer:
        assert chaos.monkey() is outer
        with chaos.inject(chaos.ChaosConfig(seed=2)) as inner:
            assert chaos.monkey() is inner
        assert chaos.monkey() is outer
    assert not chaos.is_active()


def test_compile_and_execute_faults_raise_through():
    """Under the default ``FallbackPolicy`` (no other route) an injected
    compile or tick failure that outlasts the retries reaches the caller as
    ``FallbackError``, the injected error its cause."""
    sess = _session()
    [plan] = _plans(sess, n=1)
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("torch",))):
        with pytest.raises(api.FallbackError, match="compile") as err:
            sess.compile_ticked(plan, batch=2, tick_iters=3)
    assert isinstance(err.value.__cause__, chaos.ChaosError)
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
    with chaos.inject(chaos.ChaosConfig(exec_fail_backends=("torch",))):
        engine.submit(plan, rid=0)
        with pytest.raises(api.FallbackError, match="tick") as err:
            engine.run()
    assert isinstance(err.value.__cause__, chaos.ChaosError)


def test_nan_image_is_refused_with_plan_error():
    sess = _session()
    img = np.asarray(jax_synthetic.make_synthetic_volume(seed=5, n_slices=1, shape=(40, 40)).images[0])
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=4)
    with chaos.inject(chaos.ChaosConfig(nan_image_rids=(3,))) as monkey:
        with pytest.raises(api.PlanError, match="non-finite"):
            engine.submit(monkey.poison_image(img, 3), rid=3)
    with pytest.raises(api.PlanError):
        sess.plan(np.zeros((0, 0), np.float32))
    assert engine.pending() == 0 and issubclass(api.PlanError, ValueError)


def test_submit_rejects_corrupted_plan_with_request_error():
    sess = _session()
    [plan] = _plans(sess, n=1)
    mean = plan.problem.model.region_mean.clone()
    mean[0] = float("inf")
    bad = dataclasses.replace(plan, problem=dataclasses.replace(
        plan.problem, model=plan.problem.model._replace(region_mean=mean)))
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=4)
    with pytest.raises(api.RequestError, match="region_mean"):
        engine.submit(bad)
    with pytest.raises(api.RequestError, match="deadline"):
        engine.submit(plan, deadline_s=float("nan"))
    assert engine.pending() == 0


@pytest.mark.parametrize("fault", ["bad_init", "nan_data"])
def test_poisoned_lanes_quarantined_healthy_lanes_bit_identical(fault):
    sess = _session()
    plans = _plans(sess)
    _, clean = _serve(sess, plans)
    assert all(c.status == "converged" and c.ok for c in clean.values())
    engine, chaotic = _serve(sess, plans, faults={f"{fault}_rids": (1,)})
    assert sorted(chaotic) == sorted(clean), "the engine drained every request"
    # The poisoned lane's status is its serial run's on the same corrupted inputs.
    h, m, lab0, mu0, sig0 = sess.lane_inputs(plans[1])
    m, lab0, mu0, sig0 = chaos.ChaosMonkey(chaos.ChaosConfig(seed=7, **{f"{fault}_rids": (1,)})).on_admit(
        1, m, lab0, mu0, sig0)
    serial = em_mod.run_em(h, m, lab0, mu0, sig0, sess.config.em_config())
    assert chaotic[1].status == em_mod.STATUS_NAMES[serial.status] == "diverged"
    assert not chaotic[1].ok and chaotic[1].result.em_iters == serial.em_iters <= 1
    assert engine.stats()["error_completions"] == 1
    for rid, c in chaotic.items():
        if rid != 1:
            _same(c.result, clean[rid].result)
            _same(c.result, sess.execute(plans[rid], seed=0))


def test_never_converging_lane_is_evicted_not_wedged():
    sess = _session()
    plans = _plans(sess, n=3)
    _, clean = _serve(sess, plans)
    engine, chaotic = _serve(sess, plans, faults={"never_converge_rids": (0,)}, max_ticks_resident=15)
    assert chaotic[0].status == "evicted" and not chaotic[0].ok
    assert chaotic[0].ticks_resident == 15
    assert engine.stats()["evicted"] == 1
    for rid in (1, 2):
        _same(chaotic[rid].result, clean[rid].result)
        assert chaotic[rid].status == "converged"


def test_run_max_ticks_drains_instead_of_raising():
    sess = _session()
    plans = _plans(sess, n=3)
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=4)
    for rid, p in enumerate(plans):
        engine.submit(p, rid=rid, seed=0)
    comps = engine.run(max_ticks=1)
    assert all(isinstance(c, SegCompletion) for c in comps)
    assert {c.status for c in comps} == {"evicted"} and len(comps) == 2
    assert engine.pending() == 1          # the third request stays queued
    comps2 = engine.run()                 # and a later run serves it
    assert [c.rid for c in comps2] == [2] and comps2[0].status == "converged"
    _same(comps2[0].result, sess.execute(plans[2], seed=0))


def test_slow_ticks_trip_the_straggler_watchdog(monkeypatch):
    """Every fourth tick sleeps 0.25 s.  The test's clock is a counter (each
    read 0.1 ms later, each sleep adds its seconds), so the watchdog's
    verdicts do not depend on the host's load."""
    import time

    now = [0.0]

    def perf_counter():
        now[0] += 1e-4
        return now[0]

    def sleep(seconds):
        now[0] += seconds

    sess = _session()
    plans = _plans(sess, n=4)
    monkeypatch.setattr(time, "perf_counter", perf_counter)
    monkeypatch.setattr(time, "sleep", sleep)
    engine, comps = _serve(sess, plans, faults={"slow_tick_every": 4, "slow_tick_s": 0.25})
    monkeypatch.undo()
    assert all(c.ok for c in comps.values())
    assert engine.stats()["straggler_events"] > 0
    ev = engine.watchdog.events[0]
    assert ev["seconds"] > engine.watchdog.threshold * ev["ewma"]
    assert ev["step"] % 4 == 0 and ev["seconds"] >= 0.25
