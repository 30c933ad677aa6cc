"""The port's ``FallbackPolicy`` on the CPU: the counterparts of
``tests/test_chaos.py``'s session and engine-tick fallback tests, with the
port's semantics.

* The default policy retries on the same route and then raises
  ``FallbackError`` (the injected ``ChaosError`` its cause); it takes no
  other route.
* ``FallbackPolicy(backend="torch")`` rebuilds on the plain route under
  its own cache key, with an event, a ``RuntimeWarning`` and a redirect
  that sends warm traffic straight to the fallback executable; a failure
  there too raises ``FallbackError``.
* ``enabled=False`` raises the original error after the retries.
* A transient execute failure is retried on the same route and gives the
  clean solve's bits; an engine tick is replayed only when it failed
  before its first launch, and its completions equal serial ``execute``
  bit for bit.
* A CUDA error is never retried.
* The modes' stacks (``segment_stack(batch="always")``, ``drain``): a
  compile fault of the batch executable under
  ``FallbackPolicy(backend="torch")`` and a transient execute fault under
  the default policy give the clean stack bit for bit; under the default
  policy a lasting fault raises ``FallbackError`` with no step issued and
  the requests queued again.

On the CPU a session's route is ``"torch"``.  Where a test needs a kernel
route that fails, it relabels the session's route ``"cuda"`` (a
``monkeypatch`` of ``ExecutionConfig.resolved_backend``): such executables
still run the plain versions on the CPU tensors, and the chaos harness
fails the ``"cuda"`` route.
"""

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import synthetic
from repro_torch.core.pmrf import em as em_mod
from repro_torch.kernels import ops
from repro_torch.serving import SegmentationEngine
from repro_torch.testing import chaos
from repro_torch.testing.threads import one_intra_op_thread

one_intra_op_thread()

NO_WAIT = dict(backoff_s=0.0, max_backoff_s=0.0)


def _session(mode="static-pallas", **kw):
    return api.Segmenter(api.ExecutionConfig(mode=mode, overseg_grid=(5, 5), capacity_bucket=2048,
                                             init="quantile", **kw), device="cpu")


def _plans(sess, n=1, shape=(40, 40), seed=5):
    vol = synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=shape, device="cpu")
    return [sess.plan(im) for im in vol.images]


@pytest.fixture
def kernel_route(monkeypatch):
    """Label the session's route "cuda" where the config does not ask for
    the plain one."""
    monkeypatch.setattr(api.ExecutionConfig, "resolved_backend",
                        lambda self, device: "torch" if self.backend == "torch" else "cuda")


def _images(n=2, shape=(40, 40), seed=5):
    return synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=shape, device="cpu").images


def _same(a, b):
    for f in ("region_labels", "segmentation", "mu", "sigma"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.em_iters, a.map_iters, a.status, a.total_energy) == (
        b.em_iters, b.map_iters, b.status, b.total_energy)


def test_default_policy_raises_fallback_error_after_retries(kernel_route):
    sess = _session(fallback=api.FallbackPolicy(max_retries=2, **NO_WAIT))
    [plan] = _plans(sess)
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))) as monkey:
        with pytest.raises(api.FallbackError, match="no other route") as err:
            sess.compile(plan)
    assert isinstance(err.value.__cause__, chaos.ChaosError)
    assert [e["kind"] for e in monkey.events] == ["compile_fail"] * 3  # 1 + 2 retries
    assert not sess.fallback_events and not sess.cache_keys
    with chaos.inject(chaos.ChaosConfig(exec_fail_backends=("cuda",))) as monkey:
        with pytest.raises(api.FallbackError, match="no other route") as err:
            sess.execute(plan)
    assert isinstance(err.value.__cause__, chaos.ChaosError)
    assert [e["kind"] for e in monkey.events] == ["exec_fail"] * 3
    assert all(k.backend == "cuda" for k in sess.cache_keys) and not sess.fallback_events


@pytest.mark.parametrize("mode", ["static-pallas", "faithful"])
def test_explicit_torch_policy_falls_back_with_own_cache_key(mode, kernel_route):
    sess = _session(mode, fallback=api.FallbackPolicy(backend="torch", **NO_WAIT))
    [plan] = _plans(sess)
    want = _session(mode, backend="torch").execute(plan)
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))):
        with pytest.warns(RuntimeWarning, match="falling back to 'torch'"):
            exe = sess.compile(plan)
    assert exe.key.backend == "torch" and exe.em_config.backend == "torch"
    assert [k.backend for k in sess.cache_keys] == ["torch"]
    [event] = sess.fallback_events
    assert (event["stage"], event["from"], event["to"]) == ("compile", "cuda", "torch")
    # Warm traffic: the redirect goes straight to the fallback executable,
    # with no new build and no new event.
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))) as monkey:
        assert sess.compile(plan) is exe
        got = sess.execute(plan)
    assert not monkey.events and len(sess.fallback_events) == 1 and sess.stats.hits == 2
    _same(got, want)


def test_execute_failure_falls_back_only_on_request(kernel_route):
    sess = _session(fallback=api.FallbackPolicy(backend="torch", **NO_WAIT))
    [plan] = _plans(sess)
    want = _session(backend="torch").execute(plan)
    with chaos.inject(chaos.ChaosConfig(exec_fail_backends=("cuda",))):
        with pytest.warns(RuntimeWarning, match="execute on route 'cuda' failed"):
            got = sess.execute(plan)
    _same(got, want)
    assert [e["stage"] for e in sess.fallback_events] == ["execute"]
    assert sess.compile(plan).key.backend == "torch"  # the redirect
    with chaos.inject(chaos.ChaosConfig(exec_fail_backends=("cuda", "torch"))):
        with pytest.raises(api.FallbackError):
            sess.execute(plan)  # the redirected key fails on its own route


def test_double_compile_failure_raises_fallback_error(kernel_route):
    sess = _session(fallback=api.FallbackPolicy(backend="torch", **NO_WAIT))
    [plan] = _plans(sess)
    cfg = chaos.ChaosConfig(compile_fail_backends=("cuda", "torch"))
    with chaos.inject(cfg), pytest.warns(RuntimeWarning):
        with pytest.raises(api.FallbackError, match="fallback route 'torch'") as err:
            sess.compile(plan)
    assert isinstance(err.value.__cause__, chaos.ChaosError)
    assert not sess.cache_keys


def test_fallback_disabled_reraises_original_error(kernel_route):
    sess = _session(fallback=api.FallbackPolicy(enabled=False, backend="torch", max_retries=0))
    [plan] = _plans(sess)
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))) as monkey:
        with pytest.raises(chaos.ChaosError):
            sess.compile(plan)
    assert len(monkey.events) == 1 and not sess.fallback_events


@pytest.mark.parametrize("mode", ["static-pallas", "static", "faithful"])
def test_transient_execute_failure_is_retried_same_route(mode):
    sess = _session(mode)
    [plan] = _plans(sess)
    want = sess.execute(plan, seed=0)
    with chaos.inject(chaos.ChaosConfig(transient_exec_failures=1)) as monkey:
        got = sess.execute(plan, seed=0)
    assert [e["kind"] for e in monkey.events] == ["transient_exec_fail"]
    assert not sess.fallback_events
    _same(got, want)


def _serve(sess, plans, faults=None):
    engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
    with chaos.inject(chaos.ChaosConfig(seed=7, **(faults or {}))) as monkey:
        for rid, p in enumerate(plans):
            engine.submit(p, rid=rid, seed=0)
        comps = engine.run()
    return engine, {c.rid: c for c in comps}, monkey


def test_engine_tick_transient_failure_is_replayed():
    sess = _session()
    plans = _plans(sess, n=3)
    engine, comps, monkey = _serve(sess, plans, {"transient_exec_failures": 1})
    assert [e["kind"] for e in monkey.events] == ["transient_exec_fail"]
    assert engine.stats()["tick_retries"] == 1
    for rid, p in enumerate(plans):
        _same(comps[rid].result, sess.execute(p, seed=0))


def test_engine_tick_that_launched_is_not_replayed(monkeypatch):
    """A tick that fails after its first launch has written the pool in
    place: it raises at once, whatever the retries left (the original
    error itself with the policy disabled)."""
    calls = []

    def failing_boundary(*args):
        calls.append(1)
        raise RuntimeError("boundary failed")

    monkeypatch.setattr(em_mod, "_tick_boundary", failing_boundary)
    for policy, raised in ((api.FallbackPolicy(max_retries=3, **NO_WAIT), api.FallbackError),
                           (api.FallbackPolicy(enabled=False, max_retries=3), RuntimeError)):
        sess = _session(fallback=policy)
        [plan] = _plans(sess)
        engine = SegmentationEngine(sess, max_batch=2, tick_iters=3)
        engine.submit(plan, rid=0)
        calls.clear()
        with pytest.raises(raised) as err:
            engine.run()
        assert len(calls) == 1
        cause = err.value.__cause__ if raised is api.FallbackError else err.value
        assert str(cause) == "boundary failed"
        if raised is api.FallbackError:
            assert "after its first launch" in str(err.value)


def test_cuda_errors_are_not_retried():
    policy = api.FallbackPolicy(max_retries=3, **NO_WAIT)
    calls = []

    def fails(msg):
        def run():
            calls.append(msg)
            raise RuntimeError(msg)
        return run

    with pytest.raises(RuntimeError):
        policy.retrying(fails("repro_em_tick_step: CUDA error 700 (an illegal memory access)"))
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(RuntimeError):
        policy.retrying(fails("allocator pressure"))
    assert len(calls) == 4
    assert api.config.is_cuda_error(RuntimeError("x: CUDA error 1 (invalid argument)"))
    assert not api.config.is_cuda_error(RuntimeError("CUDA out of memory"))


def test_policy_validates():
    for bad in (dict(backend="xla"), dict(max_retries=-1), dict(backoff_s=-1.0)):
        with pytest.raises(ValueError):
            api.FallbackPolicy(**bad)
    cfg = api.ExecutionConfig(fallback=api.FallbackPolicy(backend="torch"))
    assert hash(cfg) == hash(api.ExecutionConfig(fallback=api.FallbackPolicy(backend="torch")))
    assert api.ExecutionConfig().fallback == api.FallbackPolicy(enabled=True, backend=None,
                                                                max_retries=1)


@pytest.mark.parametrize("mode", ["static", "faithful"])
def test_mode_stack_compile_fault_falls_back(mode, kernel_route):
    sess = _session(mode, fallback=api.FallbackPolicy(backend="torch", **NO_WAIT))
    plans = _plans(sess, n=2)
    want = [_session(mode, backend="torch").execute(p) for p in plans]
    with chaos.inject(chaos.ChaosConfig(compile_fail_backends=("cuda",))), \
            pytest.warns(RuntimeWarning, match="falling back to 'torch'") as caught:
        for p in plans:
            sess.submit(p)
        got = sess.drain()
    assert sum(w.category is RuntimeWarning for w in caught) == 1
    [event] = sess.fallback_events
    assert (event["stage"], event["from"], event["to"]) == ("compile", "cuda", "torch")
    assert [(k.backend, k.batch) for k in sess.cache_keys] == [("torch", 2)]
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("mode", ["static", "faithful"])
def test_mode_stack_faults_under_default_policy(mode, kernel_route):
    """A transient execute fault is retried on the same route and gives the
    clean stack; a lasting compile or execute fault raises
    ``FallbackError`` with no step issued and the stack's requests queued
    again."""
    sess = _session(mode, fallback=api.FallbackPolicy(**NO_WAIT))
    images = _images()
    want, _ = sess.segment_stack(images, batch="always")
    with chaos.inject(chaos.ChaosConfig(transient_exec_failures=1)) as monkey:
        got, _ = sess.segment_stack(images, batch="always")
    assert [e["kind"] for e in monkey.events] == ["transient_exec_fail"]
    assert not sess.fallback_events
    for g, w in zip(got, want):
        _same(g, w)
    for fault in (dict(compile_fail_backends=("cuda",)), dict(exec_fail_backends=("cuda",))):
        seg = _session(mode, fallback=api.FallbackPolicy(**NO_WAIT))
        ops.reset_launch_counts()
        with chaos.inject(chaos.ChaosConfig(**fault)):
            with pytest.raises(api.FallbackError, match="no other route") as err:
                seg.segment_stack(images, batch="always")
        assert isinstance(err.value.__cause__, chaos.ChaosError)
        assert ops.LANE_STEPS == 0 and not any(ops.launch_counts().values())
        assert seg.pending() == 2 and not seg.fallback_events
