"""The port's calibrated cost model (``repro_torch.planning``) against the
JAX package's (``repro.planning``) on the CPU, and its consumers: the
session's ``plan``/``choose_batch``/``segment_stack(batch="auto")``, the
serving engine's tick-cost prior, ``launch.segment --shards auto`` and
the calibration pass itself.

Both cost models are the same float64 numpy arithmetic, so parity here is
exact: ``nnls`` and ``fit_table`` bit for bit (table bytes), every
prediction and decision ``==``.  The reference's checked-in table is read
as a data file (the port never reads it).  The port's own table is the
one measured on the card (``meta.platform`` ``"gpu"``); here it is held to
its refit, to non-negative coefficients and to monotone predictions, as
``tests/test_planning.py`` holds the reference's.  Images are 44x44 with a
6x6 grid (the reference's planning tests' size), from the port's
``synthetic``: the session tests hold the port to itself (``"auto"``
against ``"never"`` and ``"always"``), not to the JAX session.
"""

import json
import random

import numpy as np
import pytest
import torch

from repro.analysis import registry
from repro.planning import costmodel as ref_cm
from repro.planning.lsq import nnls as ref_nnls

from repro_torch import api
from repro_torch import planning
from repro_torch.core import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import segment as launch_segment
from repro_torch.planning import calibrate
from repro_torch.planning import costmodel as cm
from repro_torch.planning.lsq import nnls
from repro_torch.serving import SegmentationEngine
from repro_torch.serving.engine import TICK_COST_PRIOR

PLATFORMS = ("cpu", "gpu", "tpu")
WIDTHS = (1, 2, 4, 8)
LABELS = (2, 3, 5)
SHARDS = (1, 2, 8)
PRECISIONS = ("f32", "bf16")


def _images(n=2, shape=(44, 44), seed=3):
    return list(synthetic.make_synthetic_volume(seed=seed, n_slices=n, shape=shape, device="cpu").images)


def _fresh():
    api.reset_sessions()
    return api.Segmenter(api.ExecutionConfig(overseg_grid=(6, 6)), device="cpu")


def _tables():
    """(name, table) pairs both models are held on: the reference's
    checked-in table and each builtin default."""
    yield "reference", ref_cm.load_table()
    for platform in PLATFORMS:
        yield f"builtin {platform}", ref_cm._DEFAULT_TABLES[platform]


@pytest.fixture(autouse=True)
def _no_hatch(monkeypatch):
    monkeypatch.delenv(cm.DISABLE_ENV, raising=False)


# ---------------------------------------------------------------------------
# the fit: nnls and fit_table, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_nnls_equals_the_reference_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    m, k = int(rng.integers(5, 30)), int(rng.integers(2, 8))
    A = rng.uniform(0.0, 2.0, size=(m, k)) * 10.0 ** rng.integers(-6, 3, size=k)
    A[:, int(rng.integers(k))] = 0.0 if seed == 3 else A[:, 0]  # a zero or a repeated column
    y = rng.uniform(-0.5, 2.0, size=m)
    kw = [dict(), dict(l2=1e-6), dict(l2=1e-3, iters=50, scale=rng.uniform(0.5, 2.0, size=k))][seed % 3]
    got, want = nnls(A, y, **kw), ref_nnls(A, y, **kw)
    assert got.tobytes() == want.tobytes()
    assert (got >= 0).all()


def test_nnls_validates_shapes():
    with pytest.raises(ValueError, match="shape mismatch"):
        nnls(np.ones((3, 2)), np.ones(4))
    with pytest.raises(ValueError, match="scale"):
        nnls(np.ones((3, 2)), np.ones(3), scale=[1.0])


def test_fit_table_bytes_equal_the_reference():
    table = ref_cm.load_table()
    obs, meta = table["observations"], table["meta"]
    want = ref_cm.table_to_json(ref_cm.fit_table(obs, meta))
    assert cm.table_to_json(cm.fit_table(obs, meta)) == want
    shuffled = list(obs)
    random.Random(0).shuffle(shuffled)
    assert cm.table_to_json(cm.fit_table(shuffled, meta)) == want
    with pytest.raises(ValueError, match="solve"):
        cm.fit_table([o for o in obs if o["kind"] != "solve"], meta)


# ---------------------------------------------------------------------------
# predictions and decisions, == the reference's on the same table
# ---------------------------------------------------------------------------


def test_builtin_tables_are_the_reference_s():
    assert cm._DEFAULT_TABLES == ref_cm._DEFAULT_TABLES
    assert cm.FEATURE_NAMES == ref_cm.FEATURE_NAMES and cm.MODES == ref_cm.MODES


@pytest.mark.parametrize("name, table", list(_tables()), ids=[n for n, _ in _tables()])
def test_predictions_and_decisions_equal_the_reference(name, table):
    ours, ref = cm.CostModel(table), ref_cm.CostModel(table)
    assert ours.calibrated == ref.calibrated
    for w in WIDTHS:
        assert ours.lockstep_inflation(w) == ref.lockstep_inflation(w)
    caps = dict(max_em_iters=20, max_map_iters=10)
    for mode in cm.MODES:
        for bucket in registry.CALIBRATION_PROBE_BUCKETS:
            for k in LABELS:
                for prec in PRECISIONS:
                    kw = dict(mode=mode, bucket=bucket, n_labels=k, precision=prec)
                    for s in SHARDS:
                        assert ours.predict_solve(shards=s, **kw, **caps) == \
                            ref.predict_solve(shards=s, **kw, **caps), (mode, bucket, k, prec, s)
                    assert ours.predict_solve(**kw, em_iters=7, map_iters=32) == \
                        ref.predict_solve(**kw, em_iters=7, map_iters=32)
                    assert ours.choose_shards(candidates=SHARDS, **kw, **caps).as_dict() == \
                        ref.choose_shards(candidates=SHARDS, **kw, **caps).as_dict()
                    for w in WIDTHS:
                        assert ours.predict_batched(width=w, **kw, **caps) == \
                            ref.predict_batched(width=w, **kw, **caps)
                        assert ours.tick_cost_prior(width=w, **kw) == ref.tick_cost_prior(width=w, **kw)
                        # w lanes of shrinking capacity under the first's bucket
                        buckets = [(bucket[0] * (w + i) // (2 * w), bucket[1], bucket[2])
                                   for i in range(w)]
                        joint = tuple(max(b[d] for b in buckets) for d in range(3))
                        bd = dict(mode=mode, buckets=buckets, joint_bucket=joint, n_labels=k,
                                  precision=prec, **caps)
                        assert ours.choose_batch(**bd).as_dict() == ref.choose_batch(**bd).as_dict()
                        assert vars(ours.choose_batch(**bd)) == vars(ref.choose_batch(**bd))
        for bucket in registry.CALIBRATION_PROBE_BUCKETS:
            dec, rdec = (m.choose_shards(mode=mode, bucket=bucket, candidates=SHARDS, **caps)
                         for m in (ours, ref))
            for forced in SHARDS + (4,):
                for tol in (0.0, 0.1, 1.5):
                    assert dec.warn_if_forced(forced, tolerance=tol) == \
                        rdec.warn_if_forced(forced, tolerance=tol)


def test_warn_if_forced_as_the_reference_pins_it():
    dec = cm.ShardDecision(shards=1, predicted_s={1: 0.1, 8: 0.2})
    rdec = ref_cm.ShardDecision(shards=1, predicted_s={1: 0.1, 8: 0.2})
    assert dec.warn_if_forced(1) is None and dec.warn_if_forced(4) is None
    assert "2.00x" in dec.warn_if_forced(8) and dec.warn_if_forced(8) == rdec.warn_if_forced(8)
    assert dec.warn_if_forced(8, tolerance=1.5) is None


# ---------------------------------------------------------------------------
# the port's checked-in table: the card's
# ---------------------------------------------------------------------------


def test_checked_in_table_is_the_cards_and_refits_byte_identically(tmp_path):
    path = cm.default_table_path()
    table = cm.load_table()
    meta = table["meta"]
    assert meta["platform"] == "gpu" and meta["source"] == "calibrate"
    assert "H100" in meta["device"] and meta["nvidia_smi"].endswith(" W"), meta
    assert meta["torch"] and meta["cuda"]
    assert meta["grid"]["solve_sizes"] == {m: list(v) for m, v in calibrate.SOLVE_SIZES.items()}
    assert meta["grid"]["k_grid"] == [list(p) for p in calibrate.K_GRID]
    assert meta["grid"]["k_grid_modes"] == list(calibrate.SOLVE_SIZES)
    assert calibrate.refit(path) == path.read_text()
    # the CLI's --refit writes those bytes
    copy = tmp_path / "calibration.json"
    copy.write_text(path.read_text())
    calibrate.main(["--refit", "--out", str(copy)])
    assert copy.read_text() == path.read_text()
    for mode, coeffs in table["coefficients"].items():
        assert set(coeffs) == set(cm.FEATURE_NAMES), mode
        for name, v in coeffs.items():
            assert np.isfinite(v) and v >= 0, (mode, name, v)
    assert {o["kind"] for o in table["observations"]} >= {"solve", "batched"}
    if meta["grid"]["shard_counts"] == [1]:
        # one card: no N > 1 measured, the collective terms stay 0
        assert table["sharding"] == {"collective_fixed": 0.0, "collective_per_key": 0.0}


@pytest.mark.parametrize("mode", cm.MODES)
def test_checked_in_predictions_monotone(mode):
    m = cm.CostModel(cm.load_table())
    caps = dict(max_em_iters=20, max_map_iters=10)
    preds = [m.predict_solve(mode=mode, bucket=b, **caps) for b in registry.CALIBRATION_PROBE_BUCKETS]
    assert all(b >= a for a, b in zip(preds, preds[1:])) and all(p > 0 for p in preds), preds
    bucket = registry.CALIBRATION_PROBE_BUCKETS[1]
    preds = [m.predict_solve(mode=mode, bucket=bucket, n_labels=k, **caps) for k in (2, 3, 5, 8)]
    assert all(b >= a for a, b in zip(preds, preds[1:])), preds
    preds = [m.predict_batched(mode=mode, bucket=registry.CALIBRATION_PROBE_BUCKETS[0], width=w, **caps)
             for w in registry.CALIBRATION_PROBE_WIDTHS]
    assert all(b >= a for a, b in zip(preds, preds[1:])), preds
    a1, b1 = m.tick_cost_prior(mode=mode, bucket=bucket, width=1)
    a8, b8 = m.tick_cost_prior(mode=mode, bucket=bucket, width=8)
    assert a1 > 0 and b1 > 0 and a8 == a1 and b8 >= b1


# ---------------------------------------------------------------------------
# model_for and the escape hatch
# ---------------------------------------------------------------------------


def test_model_for_platforms_and_cache():
    cm.reset_models()
    card = cm.model_for(device="cuda")
    assert card.calibrated and card.table["meta"]["platform"] == "gpu"
    assert cm.model_for(device="cuda:0") is card and cm.model_for(platform="gpu") is card
    assert cm.model_for() is card  # None: the card
    host = cm.model_for(device="cpu")
    assert not host.calibrated and host.table is cm._DEFAULT_TABLES["cpu"]
    assert cm.model_for(platform="tpu").table is cm._DEFAULT_TABLES["tpu"]
    with pytest.raises(ValueError, match="platform"):
        cm.platform_of("meta")
    cm.reset_models()
    assert cm.model_for(device="cuda") is not card
    assert cm.model_for(device="cuda").table == card.table


def test_escape_hatch(monkeypatch):
    for legacy in (cm.legacy_batch_choice, ref_cm.legacy_batch_choice):
        assert legacy([100, 120], "gpu")
        assert not legacy([100, 300], "gpu")   # > 2x spread
        assert not legacy([100, 120], "cpu")
        assert not legacy([100], "gpu")        # one slice
    assert not cm.autotune_disabled()
    for value, disabled in (("", False), ("0", False), ("1", True)):
        monkeypatch.setenv(cm.DISABLE_ENV, value)
        assert cm.autotune_disabled() == disabled == ref_cm.autotune_disabled()


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


def test_plan_carries_the_models_prediction():
    seg = _fresh()
    plan = seg.plan(_images(1)[0])
    c = seg.config
    want = cm.model_for(device="cpu").predict_solve(
        mode=c.mode, bucket=plan.bucket, n_labels=c.n_labels, shards=c.shards,
        precision=c.precision, max_em_iters=c.max_em_iters, max_map_iters=c.max_map_iters)
    assert np.isfinite(plan.predicted_optimize_s) and plan.predicted_optimize_s == want > 0
    assert seg.cost_model() is cm.model_for(device="cpu")


def test_choose_batch_and_auto_route(monkeypatch):
    seg = _fresh()
    imgs = _images(n=3)
    plans = [seg.plan(img) for img in imgs]
    dec = seg.choose_batch(plans)
    assert isinstance(dec, planning.BatchDecision) and dec.width == 3
    assert set(dec.as_dict()) == {"use_batch", "predicted_serial_s", "predicted_batched_s",
                                  "width", "lockstep_inflation", "calibrated"}
    joint = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))
    assert dec == seg.choose_batch(plans, joint_bucket=joint)
    never, _ = seg.segment_stack(imgs, batch="never")
    always, _ = seg.segment_stack(imgs, batch="always")
    # "auto" takes the model's side: the host's builtin table batches
    # nothing, the card's batches this stack.
    for platform, use_batch in (("cpu", False), ("gpu", True)):
        model = cm.model_for(platform=platform)
        monkeypatch.setattr(api.Segmenter, "cost_model", lambda self, m=model: m)
        assert seg.choose_batch(plans).use_batch == use_batch
        seg.clear_cache()
        auto, _ = seg.segment_stack(imgs, batch="auto")
        assert {k.batch for k in seg.cache_keys} == ({3} if use_batch else {None})
        for a, b, c in zip(auto, never, always):
            for f in ("region_labels", "segmentation", "mu", "sigma"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
                np.testing.assert_array_equal(getattr(a, f), getattr(c, f), err_msg=f)
            assert (a.em_iters, a.map_iters, a.status) == (b.em_iters, b.map_iters, b.status)
        # a second "auto" builds no workspace and takes the same route
        builds, misses = ops.WORKSPACE_BUILDS, seg.stats.misses
        seg.segment_stack(imgs, batch="auto")
        assert ops.WORKSPACE_BUILDS == builds and seg.stats.misses == misses


def test_auto_under_the_escape_hatch_is_never(monkeypatch):
    monkeypatch.setenv(cm.DISABLE_ENV, "1")
    monkeypatch.setattr(api.Segmenter, "choose_batch", lambda *a, **k: pytest.fail("model asked"))
    seg = _fresh()
    imgs = _images(n=2)
    auto, _ = seg.segment_stack(imgs, batch="auto")
    assert {k.batch for k in seg.cache_keys} == {None}  # the legacy rule on the host: serial
    never, _ = seg.segment_stack(imgs, batch="never")
    for a, b in zip(auto, never):
        np.testing.assert_array_equal(a.segmentation, b.segmentation)
        np.testing.assert_array_equal(a.mu, b.mu)
        assert (a.em_iters, a.map_iters, a.status) == (b.em_iters, b.map_iters, b.status)


# ---------------------------------------------------------------------------
# the engine's tick-cost prior
# ---------------------------------------------------------------------------


def test_engine_tick_cost_prior(monkeypatch):
    seg = _fresh()
    bucket = api.BucketKey(1024, 64, 64)
    assert SegmentationEngine(seg, max_batch=4)._tick_cost_default() == TICK_COST_PRIOR  # no bucket yet
    eng = SegmentationEngine(seg, max_batch=4, bucket=bucket)
    c = seg.config
    want = cm.model_for(device="cpu").tick_cost_prior(
        mode=c.mode, bucket=bucket, width=4, n_labels=c.n_labels, precision=c.precision)
    assert eng._tick_cost_default() == want and eng.cost_model() == want  # no tick yet
    assert eng.stats()["tick_cost"]["prior"] == list(want)
    monkeypatch.setenv(cm.DISABLE_ENV, "1")
    hatch = SegmentationEngine(seg, max_batch=4, bucket=bucket)
    assert hatch._tick_cost_default() == TICK_COST_PRIOR == (5e-3, 5e-3)


# ---------------------------------------------------------------------------
# launch.segment --shards auto, and the calibration pass
# ---------------------------------------------------------------------------


def test_launch_segment_shards_auto(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    (row,) = launch_segment.main(["--size", "32", "--grid", "4", "--shards", "auto", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    (auto,) = [ln["shards_auto"] for ln in lines if "shards_auto" in ln]
    assert auto["shards"] == 1 and set(auto["predicted_seconds"]) == {"1"}
    assert auto["calibrated"] is False  # the host's builtin table
    assert row["shards"] == 1 and row["status"] in ("converged", "max_iters")
    # under torchrun: 1 and the world size; an explicit count besides
    assert launch_segment._candidates(torch.device("cpu"), 4, None) == [1, 4]
    assert launch_segment._candidates(torch.device("cpu"), 1, 2) == [1, 2]


def test_calibration_pass_at_one_point_per_kind(monkeypatch, tmp_path):
    """The pass with its grid cut to one 32x32 point per kind (a solve, a
    batched width, the sharded ladder at 1 and 2 gloo ranks): well-formed
    rows, and a table that refits byte-identically."""
    import dataclasses

    monkeypatch.setattr(calibrate, "SOLVE_SIZES", {"static-pallas": (32,)})
    monkeypatch.setattr(calibrate, "K_GRID", ())
    monkeypatch.setattr(calibrate, "BATCH_WIDTHS", (2,))
    monkeypatch.setattr(calibrate, "BATCH_CONFIG",
                        dataclasses.replace(calibrate.BATCH_CONFIG, synthetic_shape=(32, 32)))
    monkeypatch.setattr(calibrate, "BATCH_GRID", (4, 4))
    monkeypatch.setattr(calibrate, "SHARD_SIZES", (32,))
    monkeypatch.setattr(calibrate, "SHARD_COUNTS", (1, 2))
    obs = calibrate.collect_observations(device="cpu")
    assert [o["kind"] for o in obs] == ["solve", "batched", "solve", "sharded"]
    for o in obs:
        assert o["mode"] == "static-pallas" and o["k"] == 2 and o["seconds"] > 0
        assert o["cap"] >= 32 * 32 // 2 and o["em_iters"] >= 1 and o["map_iters"] >= o["em_iters"]
    assert obs[1]["width"] == 2 and obs[3]["shards"] == 2
    # the sharded rank solves what the single device solves
    assert (obs[3]["em_iters"], obs[3]["map_iters"]) == (obs[2]["em_iters"], obs[2]["map_iters"])
    meta = calibrate.table_meta("cpu", obs, sharded=True)
    assert meta["platform"] == "cpu" and meta["grid"]["shard_counts"] == [1, 2]
    path = tmp_path / "calibration.json"
    path.write_text(cm.table_to_json(cm.fit_table(obs, meta)))
    assert calibrate.refit(path) == path.read_text()
    assert cm.load_table(path)["observations"] == sorted(
        obs, key=lambda o: (o["kind"], o.get("mode", ""), o["cap"], o.get("k", 0),
                            o.get("width", 0), o.get("shards", 0), o["seconds"]))
