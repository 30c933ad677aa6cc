"""The port's sharded static-pallas route against the JAX package, on the
CPU: the label-replication arrays, ``partition_hoods``, the
``dpp_sharded`` primitives, the collective context, the sharded MAP step
and M-step, ``run_em_sharded`` on 1, 2 and 4 gloo ranks, and the session
and launcher around them.

The JAX side runs as its own tests run it here: ``run_em_sharded`` on a
one-device mesh and ``run_em(mode="static-pallas", backend="xla")``, never
through Pallas.  The problems are those of ``tests/test_torch_em.py``
(48x48; K = 2, 3, 5; quantile init), built by the JAX package and carried
across with ``convert``.

Several ranks run as ``spawn``ed processes that join a gloo group through
a ``FileStore`` under the test's ``tmp_path``
(``repro_torch.testing.ranks``); each such test kills its ranks and fails
after 120 s.  The one-rank case runs in this process, with its group torn
down after the test.

Tolerances: labels, ``em_iters``, ``map_iters``, ``status``, votes and
every integer or boolean array exact; ``mu``, ``sigma`` and hood energies
within rtol 1e-5 (atol 1e-5): the ranks' partial hood sums are added in
another order than one device adds them, and the M-step's variance
rounds once in both packages but through different arithmetic.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import distributed as jax_dist
from repro.core.pmrf import em as jax_em
from repro.core.pmrf import energy as jax_energy
from repro.core.pmrf import hoods as jax_hoods
from repro.core.pmrf import pipeline as jax_pipeline

from repro_torch import api
from repro_torch.core.pmrf import collectives, convert
from repro_torch.core.pmrf import distributed as torch_dist
from repro_torch.core.pmrf import em as torch_em
from repro_torch.core.pmrf import energy as torch_energy
from repro_torch.core.pmrf import hoods as torch_hoods
from repro_torch.core.pmrf import pipeline as torch_pipeline
from repro_torch.launch import segment as launch_segment
from repro_torch.testing import ranks

CASES = {
    2: dict(seed=0, shape=(48, 48), grid=(6, 6)),
    3: dict(seed=0, shape=(48, 48), grid=(6, 6)),
    5: dict(seed=1, shape=(48, 48), grid=(7, 7)),
}
MAX_EM, MAX_MAP = 20, 10
RANK_TIMEOUT_S = 120
REP_ARRAYS = ("rep_old_index", "rep_test_label", "rep_hood_id", "rep_valid")

_cache = {}


def _jax_problem(n_labels):
    """(JAX problem, its quantile init as numpy, the port's problem planned
    on the JAX label map)."""
    if n_labels not in _cache:
        spec = CASES[n_labels]
        if n_labels == 2:
            vol = jax_synthetic.make_synthetic_volume(seed=spec["seed"], n_slices=1, shape=spec["shape"])
        else:
            vol = jax_synthetic.make_kary_volume(
                seed=spec["seed"], n_slices=1, shape=spec["shape"], n_phases=n_labels
            )
        img = np.asarray(vol.images[0])
        jp = jax_pipeline.initialize(img, overseg_grid=spec["grid"], n_labels=n_labels)
        init = jax_em.quantile_init(jp.graph.region_mean, jp.graph.n_regions, n_labels)
        tp = torch_pipeline.initialize(
            img, n_labels=n_labels, oversegmentation=jp.labels_px, device="cpu"
        )
        _cache[n_labels] = (jp, tuple(np.asarray(a) for a in init), tp)
    return _cache[n_labels]


def _hoods_dict(h):
    d = {f: np.asarray(getattr(h, f)) for f in convert.HOODS_ARRAYS}
    d.update({f: getattr(h, f) for f in convert.HOODS_SIZES})
    return d


def _problem_dict(n_labels):
    jp, (labels0, mu0, sigma0), _ = _jax_problem(n_labels)
    d = _hoods_dict(jp.hoods)
    d.update({f: np.asarray(getattr(jp.model, f)) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    return d


def _jax_config():
    return jax_em.EMConfig(mode="static-pallas", backend="xla",
                           max_em_iters=MAX_EM, max_map_iters=MAX_MAP)


def _torch_config():
    return dict(mode="static-pallas", max_em_iters=MAX_EM, max_map_iters=MAX_MAP)


def _jax_runs(n_labels):
    """JAX ``run_em_sharded`` on a one-device mesh and JAX ``run_em``."""
    key = ("runs", n_labels)
    if key not in _cache:
        jp, (labels0, mu0, sigma0), _ = _jax_problem(n_labels)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        sharded = jax_dist.distributed_em(
            jp.hoods, jp.model, labels0, mu0, sigma0, mesh, "data", _jax_config()
        )
        single = jax_em.run_em(jp.hoods, jp.model, labels0, mu0, sigma0, _jax_config())
        _cache[key] = (sharded, single)
    return _cache[key]


def _as_numpy(res):
    if isinstance(res, dict):
        return res
    return {f: (np.asarray(getattr(res, f)) if f in ("labels", "mu", "sigma", "hood_energy")
                else int(getattr(res, f)))
            for f in ("labels", "mu", "sigma", "hood_energy", "em_iters", "map_iters", "status")}


def _assert_matches(got, want, what):
    got, want = _as_numpy(got), _as_numpy(want)
    np.testing.assert_array_equal(got["labels"], want["labels"], err_msg=what)
    assert (got["em_iters"], got["map_iters"], got["status"]) == (
        want["em_iters"], want["map_iters"], want["status"]
    ), what
    for f in ("mu", "sigma", "hood_energy"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, atol=1e-5, err_msg=f"{what}: {f}")


# ---------------------------------------------------------------------------
# hoods: replication arrays and the partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_labels", [2, 5])
def test_replication_arrays_match_jax(n_labels):
    jp, _, tp = _jax_problem(n_labels)
    for f in convert.HOODS_ARRAYS:
        np.testing.assert_array_equal(
            getattr(tp.hoods, f).numpy(), np.asarray(getattr(jp.hoods, f)), err_msg=f
        )
    assert tp.hoods.rep_valid.dtype == torch.bool
    assert int(tp.hoods.rep_valid.sum()) == 2 * tp.hoods.n_elements


def test_pad_hoods_replication_matches_jax():
    jp, _, tp = _jax_problem(2)
    h = jp.hoods
    kw = dict(capacity=h.capacity + 100, n_hoods=h.n_hoods + 7, n_regions=h.n_regions + 3)
    want = jax_hoods.pad_hoods(h, **kw)
    got = torch_hoods.pad_hoods(tp.hoods, **kw)
    for f in REP_ARRAYS:
        assert getattr(got, f).shape == (2 * got.capacity,)
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_partition_hoods_matches_jax(n_shards):
    """Array for array, and the reference's partition carried across with
    ``convert.hoods_from_numpy`` is the port's."""
    jp, _, tp = _jax_problem(2)
    want = jax_dist.partition_hoods(jp.hoods, n_shards)
    got = torch_dist.partition_hoods(tp.hoods, n_shards)
    carried = convert.hoods_from_numpy(_hoods_dict(want), device="cpu")
    assert got.capacity % n_shards == 0 and got.capacity == want.capacity
    for f in convert.HOODS_ARRAYS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        assert torch.equal(getattr(carried, f), getattr(got, f)), f
    assert (got.n_hoods, got.n_regions, got.n_elements) == (want.n_hoods, want.n_regions, want.n_elements)
    if n_shards == 1:
        assert got is tp.hoods


# ---------------------------------------------------------------------------
# the collective context and the sharded route's energy steps
# ---------------------------------------------------------------------------


def test_local_context_is_the_plain_primitives():
    ctx = collectives.LOCAL
    assert not ctx.sharded and ctx == collectives.ReduceCtx()
    x = torch.arange(4.0)
    assert ctx.psum(x) is x
    ids = torch.tensor([0, 2, 2, 5, 1], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    assert torch.equal(ctx.segment_sum(ids, vals, 3), torch.tensor([1.0, 5.0, 5.0]))
    where = torch.tensor([True, False, True, True, True])
    assert torch.equal(ctx.segment_sum(ids, vals, 3, where=where), torch.tensor([1.0, 5.0, 3.0]))
    assert torch.equal(ctx.vote_scatter(vals, ids.long(), 3, where=where), torch.tensor([1.0, 5.0, 3.0]))
    assert bool(ctx.all_converged(torch.tensor([True, True])))
    assert not bool(ctx.all_converged(torch.tensor([True, False])))


def test_map_step_fused_matches_jax():
    """One sharded-route MAP step on one device (the LOCAL context), from
    the quantile-init labels: new labels exact, hood sums within rtol."""
    jp, (labels0, mu0, sigma0), _ = _jax_problem(3)
    sctx = jax_energy.make_static_context(jp.hoods, jp.model, backend="xla")
    want_labels, want_hood = jax_energy.map_step_fused(
        jp.hoods, jp.model, sctx, labels0, mu0, sigma0, backend="xla"
    )
    tp = convert.problem_from_numpy(_problem_dict(3), device="cpu")
    tctx = torch_energy.make_static_context(tp.hoods, tp.model)
    got_labels, got_hood = torch_energy.map_step_fused(
        tp.hoods, tp.model, tctx, tp.labels0, tp.mu0, tp.sigma0
    )
    assert got_labels.dtype == torch.int32
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(got_hood.numpy(), np.asarray(want_hood), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["static-pallas", "faithful"])
def test_update_parameters_stats_matches_jax(mode):
    """The M-step of the sharded route, against the compiled JAX M-step
    (which rounds the variance once, as the port does)."""
    jp, (labels0, _, _), _ = _jax_problem(5)
    want = jax.jit(jax_energy.update_parameters_stats, static_argnums=2)(jp.model, labels0, mode)
    tp = convert.problem_from_numpy(_problem_dict(5), device="cpu")
    got = torch_energy.update_parameters_stats(tp.model, tp.labels0, mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


# ---------------------------------------------------------------------------
# several ranks
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("n_labels", sorted(CASES))
def test_run_em_sharded_one_rank_matches_jax(n_labels, one_rank_group):
    tp = convert.problem_from_numpy(_problem_dict(n_labels), device="cpu")
    got = torch_dist.run_em_sharded(
        torch_dist.partition_hoods(tp.hoods, 1), tp.model, tp.labels0, tp.mu0, tp.sigma0,
        config=torch_em.EMConfig(**_torch_config()),
    )
    sharded, single = _jax_runs(n_labels)
    _assert_matches(got, sharded, "vs JAX run_em_sharded")
    _assert_matches(got, single, "vs JAX run_em")
    assert got.status == torch_em.STATUS_CONVERGED


def test_dpp_sharded_primitives_on_two_ranks(tmp_path):
    rng = np.random.default_rng(5)
    n, segs = 1001, 37
    payload = dict(
        values=rng.normal(0.0, 1.0, n).astype(np.float32),
        ids=rng.integers(0, segs + 4, n).astype(np.int32),
        ints=rng.integers(-3, 9, n).astype(np.int32),
        num_segments=segs,
        flags=np.array([True, False]),
    )
    out = ranks.run_ranks(ranks.dpp_primitives, 2, tmp_path, payload, timeout=RANK_TIMEOUT_S)
    v, ids, ints = payload["values"], payload["ids"], payload["ints"]
    assert [o["bounds"] for o in out] == [(0, 501), (501, 1001)]
    scan = np.concatenate([o["scan"] for o in out])
    np.testing.assert_allclose(scan, np.cumsum(v, dtype=np.float64), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        np.concatenate([o["scan_exclusive"] for o in out]), scan - v, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(np.concatenate([o["scan_ints"] for o in out]), np.cumsum(ints))
    assert out[0]["scan_ints"].dtype == np.int64
    # Rank 0 holds an empty shard: its total is an int64 zero.
    assert out[0]["scan_empty"].shape == (0,) and out[0]["scan_empty"].dtype == np.int64
    np.testing.assert_array_equal(out[1]["scan_empty"], np.cumsum(ints[501:]))
    keep = ids < segs
    want_add = np.zeros(segs, np.float64)
    np.add.at(want_add, ids[keep], v[keep])
    want_min = np.full(segs, np.inf, np.float32)
    np.minimum.at(want_min, ids[keep], v[keep])
    for o in out:
        assert o["sum"] == pytest.approx(float(v.sum(dtype=np.float64)), abs=1e-3)
        assert (o["min"], o["max"]) == (float(v.min()), float(v.max()))
        np.testing.assert_allclose(o["rbk_add"], want_add, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(o["rbk_min"], want_min)
        assert o["all_converged"] is False and o["all_true"] is True
    np.testing.assert_array_equal(out[0]["rbk_add"], out[1]["rbk_add"])


@pytest.mark.parametrize("world_size", [2, 4])
def test_run_em_sharded_spawned_ranks_match_jax(world_size, tmp_path):
    """Every rank, on its own partition and on the reference's carried
    across, matches JAX run_em_sharded and run_em; with two ranks the
    launcher's sharded route also matches its single-device route, and
    ranks that hold different problems raise instead of hanging."""
    problems = {
        f"K={k}": (_problem_dict(k),
                   _hoods_dict(jax_dist.partition_hoods(_jax_problem(k)[0].hoods, world_size)),
                   _torch_config())
        for k in sorted(CASES)
    }
    argv = ["--size", "48", "--grid", "6", "--labels", "3", "--seed", "1", "--device", "cpu"]
    payload = {"problems": problems}
    if world_size == 2:
        payload.update(launcher=argv + ["--shards", "2"], mismatch=True)
    out = ranks.run_ranks(ranks.sharded_em, world_size, tmp_path, payload, timeout=RANK_TIMEOUT_S)
    for k in sorted(CASES):
        sharded, single = _jax_runs(k)
        for rank, o in enumerate(out):
            for part, got in o[f"K={k}"].items():
                what = f"K={k} rank {rank} {part}"
                _assert_matches(got, sharded, what + " vs JAX run_em_sharded")
                _assert_matches(got, single, what + " vs JAX run_em")
    if world_size == 2:
        assert all("different problems" in (o["mismatch"] or "") for o in out)
        (want,) = launch_segment.main(argv)
        for o in out:
            (row,) = o["launcher"]
            assert row["shards"] == 2 and want["shards"] == 1
            for f in ("accuracy", "em_iters", "map_iters", "status"):
                assert row[f] == want[f], f


# ---------------------------------------------------------------------------
# session and launcher
# ---------------------------------------------------------------------------


def test_session_and_launcher_validate_shards(monkeypatch):
    with pytest.raises(ValueError, match="shards"):
        api.ExecutionConfig(shards=0)
    seg = api.Segmenter(
        api.ExecutionConfig(shards=2, overseg_grid=(4, 4), init="quantile"), device="cpu"
    )
    plan = seg.plan(np.linspace(0.0, 255.0, 32 * 32, dtype=np.float32).reshape(32, 32))
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        seg.execute(plan)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="has 1 ranks"):
            seg.execute(plan)
        # shards=1 keeps the single-device route even inside a group.
        res = api.Segmenter(seg.config.with_(shards=1), device="cpu").execute(plan)
        assert res.ok and plan.partitions == {}
    finally:
        dist.destroy_process_group()
    # --shards auto on the host: the cost model's choice among the counts
    # this launch can run, one shard alone.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    (row,) = launch_segment.main(["--size", "16", "--grid", "2", "--shards", "auto", "--device", "cpu"])
    assert row["shards"] == 1
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_segment.main(["--size", "16", "--grid", "2", "--shards", "2", "--device", "cpu"])
