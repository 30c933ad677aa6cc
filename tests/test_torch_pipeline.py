"""The port end to end on the CPU: the session API and the launcher, the
whole slice against the JAX package, and the rules that keep the port
free of JAX.

The whole-slice parity plans and solves the ``tests/test_golden.py`` K=2
image (48x48, grid 6x6, quantile init) with both packages, each with its
own SLIC; segmentation, iteration counts and status must be equal.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import synthetic as jax_synthetic
from repro.core.pmrf import em as jax_em
from repro.core.pmrf import pipeline as jax_pipeline

from repro_torch import api
from repro_torch.core import metrics, synthetic
from repro_torch.kernels import ops
from repro_torch.launch import segment as launch_segment

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_segmenter_end_to_end_on_cpu():
    vol = synthetic.make_synthetic_volume(seed=3, n_slices=1, shape=(64, 64), device="cpu")
    seg = api.Segmenter(
        api.ExecutionConfig(n_labels=2, overseg_grid=(8, 8), init="quantile"), device="cpu"
    )
    ops.reset_launch_counts()
    res = seg.segment(vol.images[0])
    assert ops.launch_counts() == {
        "flash_attention": 0, "fused_em_tick": 0, "fused_map_step": 0, "mrf_min_energy": 0,
        "segment_reduce": 0,
    }
    assert res.segmentation.shape == (64, 64) and res.segmentation.dtype == np.int32
    assert res.region_labels.shape == (64,)
    assert res.ok and res.em_iters >= 1 and res.map_iters >= res.em_iters
    assert np.isfinite(res.total_energy) and np.all(np.isfinite(res.mu))
    assert metrics.evaluate(res.segmentation, vol.ground_truth[0]).accuracy > 0.85
    # bf16 energies: a drift tier, not a different segmentation.
    res16 = api.Segmenter(seg.config.with_(precision="bf16"), device="cpu").segment(vol.images[0])
    assert np.mean(res16.segmentation == res.segmentation) >= 0.95


def test_whole_slice_matches_jax():
    vol = jax_synthetic.make_synthetic_volume(seed=0, n_slices=1, shape=(48, 48))
    img = np.asarray(vol.images[0])
    jp = jax_pipeline.initialize(img, overseg_grid=(6, 6), n_labels=2)
    want = jax_pipeline.optimize(
        jp, init="quantile", config=jax_em.EMConfig(mode="static-pallas", backend="xla")
    )
    seg = api.Segmenter(api.ExecutionConfig(overseg_grid=(6, 6), init="quantile"), device="cpu")
    got = seg.segment(img)
    want_seg = np.asarray(want.labels)[: jp.graph.n_regions][jp.labels_px]
    np.testing.assert_array_equal(got.segmentation, want_seg)
    assert (got.em_iters, got.map_iters) == (int(want.em_iters), int(want.map_iters))
    assert got.status == jax_em.STATUS_NAMES[int(want.status)]
    np.testing.assert_allclose(got.mu, np.asarray(want.mu), rtol=1e-5)


@pytest.mark.parametrize("labels", [2, 3])
def test_launcher_end_to_end_on_cpu(labels, capsys):
    rows = launch_segment.main(
        ["--size", "64", "--grid", "8", "--labels", str(labels), "--seed", "0", "--device", "cpu"]
    )
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    # One line per repeat of the stack, one per slice, then the summary.
    repeat, *slices, summary = lines
    assert slices == rows and len(rows) == 1
    assert repeat["repeat"] == 0 and repeat["cache"] == {"hits": 0, "misses": 1, "evictions": 0}
    assert summary["mean_accuracy"] == rows[0]["accuracy"] and summary["batch"] == "auto"
    row = rows[0]
    assert set(row) >= {"accuracy", "em_iters", "map_iters", "status", "optimize_s"}
    assert row["status"] in ("converged", "max_iters") and row["device"] == "cpu"
    assert row["accuracy"] > 0.6


def test_plan_rejects_unusable_images():
    seg = api.Segmenter(device="cpu")
    with pytest.raises(api.PlanError, match="non-finite"):
        seg.plan(np.full((16, 16), np.nan, np.float32))
    with pytest.raises(api.PlanError, match="zero-element"):
        seg.plan(np.zeros((0, 4), np.float32))


def test_execution_config_validates():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.ExecutionConfig(mode="faithful")
    for bad in (dict(mode="nope"), dict(precision="fp16"), dict(backend="xla"),
                dict(init="zeros"), dict(n_labels=1)):
        with pytest.raises(ValueError):
            api.ExecutionConfig(**bad)
    cfg = api.ExecutionConfig(overseg_grid=[4, 4])
    assert cfg.overseg_grid == (4, 4) and cfg.with_(backend="torch").em_config().backend == "torch"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Segmenter()
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.make_synthetic_volume(n_slices=1, shape=(8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_segment.main(["--size", "8", "--grid", "2"])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = "import sys, repro_torch, repro_torch.api, repro_torch.launch.segment, repro_torch.launch.serve_lm, repro_torch.models.convert; print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """Without a CUDA device, or copied away from the package, the smoke
    script exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    away = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    for out in (here, away):
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
