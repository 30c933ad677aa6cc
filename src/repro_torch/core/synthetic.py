"""Synthetic porous-media volumes + corruption models (paper §4.1.1).

Counterpart of ``repro.core.synthetic``: a smooth Gaussian random field
thresholded into phases, then ringing, Gaussian noise and salt & pepper.
The randomness comes from a ``torch.Generator`` seeded with ``seed``; it
cannot reproduce ``jax.random`` streams, so the same seed gives another
(statistically alike) volume than the reference, and parity tests take
their images from the reference generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

# Grayscale levels assigned to the two ground-truth phases before corruption.
VOID_LEVEL = 60.0
SOLID_LEVEL = 180.0


def _smooth_field(
    gen: torch.Generator, shape: Tuple[int, int], correlation_length: float
) -> torch.Tensor:
    """White noise low-passed in Fourier space (bandwidth ~ 1/length)."""
    h, w = shape
    dev = gen.device
    noise = torch.randn(shape, generator=gen, device=dev)
    fy = torch.fft.fftfreq(h, device=dev)[:, None]
    fx = torch.fft.fftfreq(w, device=dev)[None, :]
    lp = torch.exp(
        -0.5 * ((fy ** 2 + fx ** 2) * (correlation_length ** 2) * (2 * math.pi) ** 2)
    )
    return torch.fft.ifft2(torch.fft.fft2(noise) * lp).real


def porous_ground_truth(
    gen: torch.Generator,
    shape: Tuple[int, int] = (128, 128),
    porosity: float = 0.45,
    correlation_length: float = 8.0,
) -> torch.Tensor:
    """Binary (0=void, 1=solid) porous structure: a smooth random field
    thresholded at the requested porosity quantile."""
    field = _smooth_field(gen, shape, correlation_length)
    thresh = torch.quantile(field.reshape(-1), porosity)
    return (field > thresh).to(torch.int32)


def kary_ground_truth(
    gen: torch.Generator,
    shape: Tuple[int, int] = (128, 128),
    n_phases: int = 3,
    correlation_length: float = 8.0,
) -> torch.Tensor:
    """K-phase ground truth: the same field cut at K-1 equal-mass quantiles."""
    if n_phases < 2:
        raise ValueError(f"n_phases must be >= 2, got {n_phases}")
    field = _smooth_field(gen, shape, correlation_length)
    qs = torch.linspace(0.0, 1.0, n_phases + 1, device=field.device)[1:-1]
    cuts = torch.quantile(field.reshape(-1), qs)
    gt = torch.zeros(shape, dtype=torch.int32, device=field.device)
    for q in cuts:
        gt = gt + (field > q).to(torch.int32)
    return gt


def phase_levels(n_phases: int) -> np.ndarray:
    """Grayscale level per phase, evenly spread over [VOID_LEVEL, SOLID_LEVEL]."""
    return np.linspace(VOID_LEVEL, SOLID_LEVEL, n_phases).astype(np.float32)


def corrupt_base(
    gen: torch.Generator,
    base: torch.Tensor,
    *,
    gaussian_sigma: float,
    salt_pepper_frac: float,
    ringing_amplitude: float,
    ringing_period: float,
) -> torch.Tensor:
    """Ringing + Gaussian noise + salt & pepper + clip to [0, 255]."""
    h, w = base.shape
    dev = base.device
    yy = torch.arange(h, device=dev)[:, None] - h / 2.0
    xx = torch.arange(w, device=dev)[None, :] - w / 2.0
    r = torch.sqrt(yy ** 2 + xx ** 2)
    img = base + ringing_amplitude * torch.sin(2.0 * math.pi * r / ringing_period)
    img = img + gaussian_sigma * torch.randn((h, w), generator=gen, device=dev)
    u = torch.rand((h, w), generator=gen, device=dev)
    salt = u < (salt_pepper_frac / 2.0)
    pepper = (u >= salt_pepper_frac / 2.0) & (u < salt_pepper_frac)
    img = torch.where(salt, 255.0, img)
    img = torch.where(pepper, 0.0, img)
    return torch.clamp(img, 0.0, 255.0).to(torch.float32)


@dataclass
class SyntheticVolume:
    """A stack of corrupted 2D slices + ground truth."""

    images: torch.Tensor        # (slices, H, W) float32 in [0, 255]
    ground_truth: torch.Tensor  # (slices, H, W) int32 phase ids


def make_synthetic_volume(
    seed: int = 0,
    n_slices: int = 4,
    shape: Tuple[int, int] = (128, 128),
    porosity: float = 0.45,
    *,
    gaussian_sigma: float = 60.0,
    salt_pepper_frac: float = 0.03,
    ringing_amplitude: float = 20.0,
    ringing_period: float = 9.0,
    device: DeviceLike = None,
) -> SyntheticVolume:
    """Binary porous volume (the paper's synthetic benchmark, at ``shape``)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    gts, imgs = [], []
    for _ in range(n_slices):
        gt = porous_ground_truth(gen, shape, porosity)
        base = torch.where(gt > 0, SOLID_LEVEL, VOID_LEVEL)
        imgs.append(
            corrupt_base(
                gen, base, gaussian_sigma=gaussian_sigma,
                salt_pepper_frac=salt_pepper_frac,
                ringing_amplitude=ringing_amplitude, ringing_period=ringing_period,
            )
        )
        gts.append(gt)
    return SyntheticVolume(images=torch.stack(imgs), ground_truth=torch.stack(gts))


def make_kary_volume(
    seed: int = 0,
    n_slices: int = 4,
    shape: Tuple[int, int] = (128, 128),
    n_phases: int = 3,
    *,
    gaussian_sigma: float | None = None,
    salt_pepper_frac: float = 0.03,
    ringing_amplitude: float | None = None,
    ringing_period: float = 9.0,
    device: DeviceLike = None,
) -> SyntheticVolume:
    """K-phase volume: phases mapped to K gray levels, then the corruption
    stack with noise scaled by 1/K (defaults 120/K and 40/K) so adjacent
    phases stay separable."""
    if gaussian_sigma is None:
        gaussian_sigma = 120.0 / n_phases
    if ringing_amplitude is None:
        ringing_amplitude = 40.0 / n_phases
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    levels = torch.as_tensor(phase_levels(n_phases), device=gen.device)
    gts, imgs = [], []
    for _ in range(n_slices):
        gt = kary_ground_truth(gen, shape, n_phases)
        imgs.append(
            corrupt_base(
                gen, levels[gt.long()], gaussian_sigma=gaussian_sigma,
                salt_pepper_frac=salt_pepper_frac,
                ringing_amplitude=ringing_amplitude, ringing_period=ringing_period,
            )
        )
        gts.append(gt)
    return SyntheticVolume(images=torch.stack(imgs), ground_truth=torch.stack(gts))
