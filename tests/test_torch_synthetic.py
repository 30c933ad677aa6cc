"""The port's init functions that the calibration and the CLI read, against
the JAX package's on the CPU: ``oversegment.grid_oversegment``,
``synthetic.threshold_baseline``, ``synthetic.corrupt`` and
``synthetic.make_experimental_like_volume``, and ``launch.segment
--dataset experimental``.

``grid_oversegment`` and ``threshold_baseline`` are deterministic and
equal the reference's exactly.  The corruption's randomness comes from a
seeded ``torch.Generator`` and cannot reproduce ``jax.random``'s streams,
so the volumes are held as far as that allows: shapes and dtypes, a
two-phase ground truth, the same volume from the same seed, and each
phase's mean intensity within 3 standard errors of the mean the
corruption model predicts from the reference's levels (a clipped normal
around level + ringing at each pixel, salt and pepper mixed in), on the
port's volume and on the reference's alike.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oversegment as ref_overseg
from repro.core import synthetic as ref_synthetic

from repro_torch.core import oversegment, synthetic
from repro_torch.launch import segment as launch_segment

_erf = np.vectorize(math.erf)
CORRUPT = dict(gaussian_sigma=60.0, salt_pepper_frac=0.03, ringing_amplitude=20.0, ringing_period=9.0)
EXPERIMENTAL = dict(gaussian_sigma=45.0, salt_pepper_frac=0.05, ringing_amplitude=25.0, ringing_period=9.0)


@pytest.mark.parametrize("shape, block", [((44, 44), 4), ((45, 37), 4), ((16, 9), 3), ((8, 8), 8)])
def test_grid_oversegment_equals_the_reference(shape, block):
    img = np.zeros(shape, np.float32)
    got = oversegment.grid_oversegment(img, block, device="cpu")
    want = np.asarray(ref_overseg.grid_oversegment(jnp.asarray(img), block))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_baseline_equals_the_reference():
    vol = ref_synthetic.make_experimental_like_volume(seed=2, n_slices=2, shape=(48, 40))
    for im in vol.images:
        got = synthetic.threshold_baseline(torch.from_numpy(np.array(im)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_synthetic.threshold_baseline(im)))


def _expected_phase_means(gt: np.ndarray, levels, *, gaussian_sigma, salt_pepper_frac,
                          ringing_amplitude, ringing_period):
    """Each phase's expected mean under the corruption model: at a pixel,
    (1 - f) * E[clip(level + ringing + sigma * Z, 0, 255)] + f/2 * 255."""
    h, w = gt.shape
    yy = np.arange(h)[:, None] - h / 2.0
    xx = np.arange(w)[None, :] - w / 2.0
    ring = ringing_amplitude * np.sin(2.0 * np.pi * np.sqrt(yy ** 2 + xx ** 2) / ringing_period)
    m = np.asarray(levels, np.float64)[gt] + ring
    s = gaussian_sigma
    cdf = lambda x: 0.5 * (1.0 + _erf(x / math.sqrt(2.0)))  # noqa: E731
    pdf = lambda x: np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)  # noqa: E731
    a, b = (0.0 - m) / s, (255.0 - m) / s
    clipped = m * (cdf(b) - cdf(a)) + s * (pdf(a) - pdf(b)) + 255.0 * (1.0 - cdf(b))
    e = (1.0 - salt_pepper_frac) * clipped + salt_pepper_frac / 2.0 * 255.0
    return [float(e[gt == p].mean()) for p in range(len(levels))]


def _check_phase_levels(images, gts, params, what):
    levels = (ref_synthetic.VOID_LEVEL, ref_synthetic.SOLID_LEVEL)
    for img, gt in zip(np.asarray(images), np.asarray(gts)):
        expected = _expected_phase_means(gt, levels, **params)
        for p, want in enumerate(expected):
            px = img[gt == p].astype(np.float64)
            se = px.std() / math.sqrt(px.size)
            assert abs(px.mean() - want) <= 3.0 * se, (what, p, px.mean(), want, se)


def _check_volume(vol, n, shape):
    assert vol.images.shape == vol.ground_truth.shape == (n, *shape)
    assert vol.images.dtype == torch.float32 and vol.ground_truth.dtype == torch.int32
    assert float(vol.images.min()) >= 0.0 and float(vol.images.max()) <= 255.0
    for gt in vol.ground_truth:
        assert set(torch.unique(gt).tolist()) == {0, 1}
        assert 0.3 < float(gt.float().mean()) < 0.7


def test_corrupt_phase_levels():
    gen = torch.Generator().manual_seed(0)
    gt = torch.zeros((128, 128), dtype=torch.int32)
    gt[:, 64:] = 1
    gt[40:90, 20:50] = 1
    img = synthetic.corrupt(gen, gt)
    assert img.shape == gt.shape and img.dtype == torch.float32
    _check_phase_levels(img[None], gt[None], CORRUPT, "port corrupt")
    again = synthetic.corrupt(torch.Generator().manual_seed(0), gt)
    assert torch.equal(img, again)
    # the binary volume's corruption is this one
    vol = synthetic.make_synthetic_volume(seed=0, n_slices=1, shape=(64, 64), device="cpu")
    _check_phase_levels(vol.images, vol.ground_truth, CORRUPT, "port synthetic volume")


def test_experimental_like_volume():
    n, shape = 2, (128, 128)
    vol = synthetic.make_experimental_like_volume(seed=1, n_slices=n, shape=shape, device="cpu")
    _check_volume(vol, n, shape)
    _check_phase_levels(vol.images, vol.ground_truth, EXPERIMENTAL, "port")
    ref = ref_synthetic.make_experimental_like_volume(seed=1, n_slices=n, shape=shape)
    assert ref.images.shape == tuple(vol.images.shape) and ref.images.dtype == jnp.float32
    _check_phase_levels(ref.images, ref.ground_truth, EXPERIMENTAL, "reference")
    same = synthetic.make_experimental_like_volume(seed=1, n_slices=n, shape=shape, device="cpu")
    assert torch.equal(vol.images, same.images) and torch.equal(vol.ground_truth, same.ground_truth)
    other = synthetic.make_experimental_like_volume(seed=2, n_slices=n, shape=shape, device="cpu")
    assert not torch.equal(vol.ground_truth, other.ground_truth)
    # denser than the synthetic regime: the XOR of two fields has more
    # phase boundaries than one field alone
    binary = synthetic.make_synthetic_volume(seed=1, n_slices=n, shape=shape, device="cpu")
    edges = lambda gt: int((gt[:, 1:] != gt[:, :-1]).sum() + (gt[1:] != gt[:-1]).sum())  # noqa: E731
    assert edges(vol.ground_truth[0]) > edges(binary.ground_truth[0])


def test_launch_segment_dataset_experimental(capsys):
    rows = launch_segment.main(["--size", "32", "--grid", "4", "--slices", "2", "--dataset",
                                "experimental", "--device", "cpu"])
    assert len(rows) == 2 and all(r["status"] in ("converged", "max_iters") for r in rows)
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["dataset"] == "experimental" and 0.0 <= summary["mean_accuracy"] <= 1.0
    with pytest.raises(SystemExit):
        launch_segment.main(["--labels", "3", "--dataset", "experimental", "--device", "cpu"])
