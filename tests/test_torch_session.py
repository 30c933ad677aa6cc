"""The port's session API (``repro_torch.api``) on the CPU: buckets, the
executable cache, ``submit``/``drain``, ``segment_stack`` and the
deprecated shims, mirroring ``tests/test_api.py``.

The reference counts traces (``em.TRACE_COUNTS``); the port runs eagerly,
so its counterpart of "zero retrace on a warm hit" is zero workspace
builds (``kernels.ops.WORKSPACE_BUILDS``).  Results of the batched path
are held bit for bit to the serial ``execute`` and, through the shims, to
the JAX session's ``segment_image`` on the same images (labels, iteration
counts and status exactly; mu and sigma within rtol 1e-5, the tiers of
``tests/test_torch_em.py``).  Images are 40-64 px with grids of 6-8, made
by the JAX package's ``synthetic`` (numpy underneath) so both packages see
the same pixels.
"""

import warnings

import numpy as np
import pytest

from repro import api as jax_api
from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import pipeline as jax_pipeline

from repro_torch import api
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import pipeline
from repro_torch.kernels import ops


def _images(n=2, shape=(44, 44), seed=3):
    vol = jax_synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=shape)
    return [np.asarray(im) for im in vol.images]


def _fresh(config=None):
    api.reset_sessions()
    return api.Segmenter(config or api.ExecutionConfig(overseg_grid=(6, 6)), device="cpu")


def _same(a, b):
    for f in ("region_labels", "segmentation", "mu", "sigma"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.em_iters, a.map_iters, a.status, a.total_energy) == (
        b.em_iters, b.map_iters, b.status, b.total_energy)


@pytest.mark.parametrize("bad, match", [
    (dict(capacity_bucket=0), "bucket"),
    (dict(segment_bucket=0), "bucket"),
    (dict(max_cached_executables=0), "max_cached"),
])
def test_config_validates_bucketing(bad, match):
    with pytest.raises(ValueError, match=match):
        api.ExecutionConfig(**bad)


def test_config_bucketing_defaults_match_the_reference():
    ours, ref = api.ExecutionConfig(), jax_api.ExecutionConfig()
    for f in ("capacity_bucket", "segment_bucket", "max_cached_executables"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.resolved_backend("cpu") == "torch" and ours.resolved_backend("cuda:0") == "cuda"
    assert ours.with_(backend="torch").resolved_backend("cuda:0") == "torch"


def test_bucket_of_matches_the_reference():
    img = _images(1)[0]
    ours = _fresh().plan(img)
    ref = jax_api.Segmenter(jax_api.ExecutionConfig(overseg_grid=(6, 6))).plan(img)
    assert tuple(ours.bucket) == tuple(ref.bucket)


def test_second_same_bucket_execute_is_zero_trace():
    """The port's form: the second same-bucket execute builds no workspace."""
    seg = _fresh()
    img_a, img_b = _images(2)
    overseg = np.repeat(np.repeat(np.arange(36).reshape(6, 6), 8, 0), 8, 1)[:44, :44]
    plan_a = seg.plan(img_a, oversegmentation=overseg)
    plan_b = seg.plan(img_b, oversegmentation=overseg)
    assert plan_a.bucket == plan_b.bucket

    res_a = seg.execute(plan_a)
    assert seg.stats.misses == 1
    builds = ops.WORKSPACE_BUILDS
    res_b = seg.execute(plan_b)
    assert ops.WORKSPACE_BUILDS == builds, "a warm execute must build no workspace"
    assert seg.stats.hits == 1
    assert np.isfinite(res_a.total_energy) and np.isfinite(res_b.total_energy)
    assert res_b.segmentation.shape == img_b.shape


def test_different_bucket_misses():
    seg = _fresh(api.ExecutionConfig(overseg_grid=(6, 6), capacity_bucket=1, segment_bucket=1))
    plan_a = seg.plan(_images(1, (40, 40), 0)[0])
    plan_b = seg.plan(_images(1, (64, 64), 1)[0])
    assert plan_a.bucket != plan_b.bucket

    seg.execute(plan_a)
    builds = ops.WORKSPACE_BUILDS
    seg.execute(plan_b)
    assert ops.WORKSPACE_BUILDS == builds + 1
    assert seg.stats.misses == 2 and seg.stats.hits == 0
    assert len(seg.cache_keys) == 2


def test_cache_eviction_respects_max_size():
    seg = _fresh(api.ExecutionConfig(overseg_grid=(6, 6), capacity_bucket=1, segment_bucket=1,
                                     max_cached_executables=1))
    plan_a = seg.plan(_images(1, (40, 40), 0)[0])
    plan_b = seg.plan(_images(1, (64, 64), 1)[0])
    assert plan_a.bucket != plan_b.bucket

    exe_a = seg.compile(plan_a)
    seg.compile(plan_b)  # evicts a (LRU, max size 1)
    assert seg.stats.evictions == 1
    assert len(seg.cache_keys) == 1
    assert seg.cache_keys[0].capacity == plan_b.bucket.capacity
    seg.compile(plan_a)  # a is gone: a miss, not a hit
    assert seg.stats.misses == 3
    assert exe_a.key.backend == "torch"  # keys pin the route, never "auto"


def test_compile_accepts_bucket_key_without_data():
    seg = _fresh()
    bucket = seg.plan(_images(1)[0]).bucket
    seg2 = api.Segmenter(seg.config, device="cpu")
    builds = ops.WORKSPACE_BUILDS
    exe = seg2.compile(api.BucketKey(*bucket))
    assert seg2.stats.misses == 1 and ops.WORKSPACE_BUILDS == builds + 1
    assert exe.key.batch is None and exe.key.tick_iters is None and exe.compile_seconds > 0.0
    assert exe.workspace.shape == (bucket.capacity, bucket.n_hoods, bucket.n_regions + 1, 2)
    batched = seg2.compile(bucket, batch=3)
    assert batched.key.batch == 3 and batched.workspace.batch == 3


def test_submit_8_compiles_once_and_matches_serial():
    seg = _fresh(api.ExecutionConfig(overseg_grid=(6, 6), capacity_bucket=2048))
    imgs = _images(8, shape=(44, 44), seed=5)
    plans = [seg.plan(img) for img in imgs]
    assert len({p.bucket for p in plans}) == 1, "test premise: one bucket"

    builds = ops.WORKSPACE_BUILDS
    tickets = [seg.submit(p, seed=0) for p in plans]
    assert seg.pending() == 8
    batched = seg.drain()
    assert seg.pending() == 0
    assert ops.WORKSPACE_BUILDS == builds + 1  # ONE batch-8 workspace for all 8 requests
    assert seg.stats.misses == 1 and tickets == list(range(8)) and len(batched) == 8
    # A second drain of the same group builds nothing.
    for p in plans:
        seg.submit(p, seed=0)
    again = seg.drain()
    assert ops.WORKSPACE_BUILDS == builds + 1 and seg.stats.hits == 1
    for a, b in zip(batched, again):
        _same(a, b)

    # Bit for bit the serial execute and the port's legacy one-shot.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for img, plan, got in zip(imgs, plans, batched):
            _same(got, seg.execute(plan, seed=0))
            want = pipeline.segment_image(img, overseg_grid=(6, 6), seed=0, device="cpu")
            np.testing.assert_array_equal(got.region_labels, want.region_labels)
            assert got.em_iters == want.em_iters


def test_drain_groups_mixed_buckets():
    seg = _fresh(api.ExecutionConfig(overseg_grid=(6, 6), capacity_bucket=2048))
    pa1, pa2 = (seg.plan(im) for im in _images(2, (40, 40), 0))
    overseg = np.repeat(np.repeat(np.arange(256).reshape(16, 16), 4, 0), 4, 1)
    pb = seg.plan(_images(1, (64, 64), 1)[0], oversegmentation=overseg)
    assert pa1.bucket == pa2.bucket != pb.bucket

    seg.submit(pa1)
    seg.submit(pb)
    seg.submit(pa2)
    results = seg.drain()
    assert [r.segmentation.shape for r in results] == [(40, 40), (64, 64), (40, 40)]
    assert {k.batch for k in seg.cache_keys} == {None, 2}
    for plan, got in zip((pa1, pb, pa2), results):
        _same(got, seg.execute(plan))


def test_drain_empty_is_noop():
    assert _fresh().drain() == []


def test_drain_failure_requeues_unprocessed():
    seg = _fresh()
    plan = seg.plan(_images(1)[0])
    seg.submit(plan, bucket=api.BucketKey(1, 1, 1))  # smaller than the plan's hoods
    seg.submit(plan)
    with pytest.raises(ValueError, match="smaller than hoods"):
        seg.drain()
    assert seg.pending() == 2
    seg._pending.pop(0)
    assert len(seg.drain()) == 1


@pytest.mark.parametrize("n_labels", [2, 3])
def test_segment_stack_batched_equals_serial_and_jax(n_labels):
    """``segment_stack(batch="always")`` (one batched solve under the joint
    bucket) against ``"never"`` (each slice alone, in its own bucket), bit
    for bit, and against the JAX session's ``segment_stack`` on the same
    images at f32: labels, counts and status exact, mu/sigma rtol 1e-5."""
    if n_labels == 2:
        vol = jax_synthetic.make_synthetic_volume(seed=2, n_slices=4, shape=(48, 48))
    else:
        vol = jax_synthetic.make_kary_volume(seed=2, n_slices=4, shape=(48, 48), n_phases=3)
    imgs = [np.asarray(im) for im in vol.images]
    cfg = dict(overseg_grid=(6, 6), n_labels=n_labels, init="quantile")
    seg = _fresh(api.ExecutionConfig(**cfg))
    batched, mean_b = seg.segment_stack(imgs, batch="always")
    builds = ops.WORKSPACE_BUILDS
    warm, _ = seg.segment_stack(imgs, batch="always")
    assert ops.WORKSPACE_BUILDS == builds
    serial, mean_s = seg.segment_stack(imgs, batch="never")
    assert mean_b > 0.0 and mean_s > 0.0
    for a, b, c in zip(batched, warm, serial):
        _same(a, b)
        _same(a, c)
    ref = jax_api.Segmenter(jax_api.ExecutionConfig(mode="static-pallas", backend="xla", **cfg))
    want, _ = ref.segment_stack(imgs, batch="always")
    for got, w in zip(batched, want):
        np.testing.assert_array_equal(got.region_labels, w.region_labels)
        assert (got.em_iters, got.map_iters, got.status) == (w.em_iters, w.map_iters, w.status)
        np.testing.assert_allclose(got.mu, w.mu, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.sigma, w.sigma, rtol=1e-5, atol=1e-5)


def test_segment_stack_refusals_and_auto():
    seg = _fresh()
    with pytest.raises(ValueError, match="batch"):
        seg.segment_stack(_images(1), batch="maybe")
    with pytest.raises(ValueError, match="empty"):
        seg.segment_stack([])
    with pytest.raises(ValueError, match="shards > 1"):
        api.Segmenter(seg.config.with_(shards=2), device="cpu").segment_stack(_images(1), batch="always")
    with pytest.raises(ValueError, match="shards > 1"):
        api.Segmenter(seg.config.with_(shards=2), device="cpu").compile((256, 64, 64), batch=2)
    # "auto" on the CPU solves serially (the reference's rule without its cost model).
    seg.segment_stack(_images(2), batch="auto")
    assert {k.batch for k in seg.cache_keys} == {None}
    assert api.session.legacy_batch_choice([1000, 1900], "cuda")
    assert not api.session.legacy_batch_choice([1000, 2100], "cuda")
    assert not api.session.legacy_batch_choice([1000, 1000], "cpu")


def test_segment_image_shim_warns_and_matches_session():
    img = _images(1)[0]
    api.reset_sessions()
    with pytest.warns(DeprecationWarning, match="segment_image is deprecated"):
        legacy = pipeline.segment_image(img, overseg_grid=(6, 6), seed=0, device="cpu")
    sess = api.session_for(api.ExecutionConfig(overseg_grid=(6, 6)), device="cpu")
    assert api.session_for(api.ExecutionConfig(overseg_grid=[6, 6]), device="cpu") is sess
    _same(legacy, sess.segment(img, seed=0))
    # The reference's shim on the same image, at its default mode on the
    # port's one route.
    with pytest.warns(DeprecationWarning):
        want = jax_pipeline.segment_image(img, overseg_grid=(6, 6), seed=0, mode="static-pallas",
                                          backend="xla", init="quantile")
    with pytest.warns(DeprecationWarning):
        got = pipeline.segment_image(img, overseg_grid=(6, 6), seed=0, init="quantile", device="cpu")
    np.testing.assert_array_equal(got.region_labels, want.region_labels)
    assert (got.em_iters, got.map_iters) == (want.em_iters, want.map_iters)


def test_segment_volume_shim_warns_and_validates():
    with pytest.warns(DeprecationWarning, match="segment_volume is deprecated"):
        with pytest.raises(ValueError, match="batch"):
            pipeline.segment_volume([np.zeros((8, 8))], batch="maybe", device="cpu")
    with pytest.warns(DeprecationWarning, match="segment_volume is deprecated"):
        results, mean_s = pipeline.segment_volume(_images(2), overseg_grid=(6, 6), batch="always",
                                                  device="cpu")
    assert len(results) == 2 and mean_s > 0.0
    assert pipeline._can_batch([p.problem for p in (_fresh().plan(im) for im in _images(2))])


def test_session_for_is_bounded_and_reset():
    api.reset_sessions()
    sessions = [api.session_for(api.ExecutionConfig(beta=0.5 + 0.01 * i), device="cpu")
                for i in range(api.session.MAX_SESSIONS + 2)]
    assert len(api.session._SESSIONS) == api.session.MAX_SESSIONS
    assert api.session_for(sessions[-1].config, device="cpu") is sessions[-1]
    assert api.default_session(device="cpu").config == api.ExecutionConfig()
    api.reset_sessions()
    assert not api.session._SESSIONS


def test_label_padded_plan_keeps_its_trajectory():
    """A K = 2 plan run by a K = 3 session: the extra label is inert
    (``energy.pad_model_labels``) and the real labels take the K = 2
    trajectory; a plan with more labels than the session is refused."""
    img = _images(1)[0]
    k2 = _fresh(api.ExecutionConfig(overseg_grid=(6, 6), init="quantile"))
    plan = k2.plan(img)
    want = k2.execute(plan)
    k3 = api.Segmenter(k2.config.with_(n_labels=3), device="cpu")
    got = k3.execute(plan)
    np.testing.assert_array_equal(got.region_labels, want.region_labels)
    np.testing.assert_array_equal(got.mu[:2], want.mu)
    assert got.mu[2] == em_mod.INERT_MU
    assert (got.em_iters, got.map_iters) == (want.em_iters, want.map_iters)
    with pytest.raises(ValueError, match="re-plan"):
        k2.execute(k3.plan(img))
