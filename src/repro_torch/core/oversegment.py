"""Oversegmentation (superpixels): the PMRF preprocessing step.

Counterpart of ``repro.core.oversegment.slic``: grid-seeded k-means over
(y, x, intensity) features, with the reference's per-entry arithmetic and
its first-index tie rule.  The reference builds the whole (pixels x seeds)
distance matrix; at a 512x512 slice with 1024 seeds that is 268 M floats
for each temporary, so here the pixels are taken in chunks.

The centroid sums of a Lloyd iteration are one ``dpp.reduce_by_key``:
on the card ``segment_reduce``'s order-free ``add``, so that a plan is the
same bit for bit from run to run (float atomics would add the intensities
in a different order each time); on the CPU the plain version, which adds
in pixel order as ``jax.ops.segment_sum`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device, to_tensor
from repro_torch.core import dpp

#: Distance-matrix entries per chunk (pixels x seeds), 128 MB of float32.
CHUNK_ENTRIES = 1 << 25


def slic(
    image,
    grid: Tuple[int, int] = (16, 16),
    iters: int = 5,
    compactness: float = 0.5,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Grid-seeded superpixel oversegmentation.

    Args:
      image: (H, W) image (any scale; normalized internally).
      grid: seeds along (rows, cols); n_regions = grid[0] * grid[1].
      iters: Lloyd iterations.
      compactness: weight of the spatial term relative to intensity.
      device: where to run (``None``: the CUDA device).

    Returns:
      (H, W) int32 label map with labels in [0, n_regions), on ``device``.
    """
    dev = resolve_device(device)
    image = to_tensor(image, torch.float32, dev)
    h, w = image.shape
    gy, gx = grid
    k = gy * gx

    # Light 3x3 box smoothing, summed in the reference's order.
    pad = F.pad(image[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sm = (
        pad[:-2, :-2] + pad[:-2, 1:-1] + pad[:-2, 2:]
        + pad[1:-1, :-2] + pad[1:-1, 1:-1] + pad[1:-1, 2:]
        + pad[2:, :-2] + pad[2:, 1:-1] + pad[2:, 2:]
    ) / 9.0
    img = (sm - sm.mean()) / (sm.std(correction=0) + 1e-6)

    f32 = torch.float32
    ys = (torch.arange(gy, device=dev, dtype=f32) + 0.5) * (h / gy)
    xs = (torch.arange(gx, device=dev, dtype=f32) + 0.5) * (w / gx)
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    step = max(h / gy, w / gx)

    py, px = torch.meshgrid(
        torch.arange(h, device=dev, dtype=f32), torch.arange(w, device=dev, dtype=f32), indexing="ij"
    )
    feats_y = py.reshape(-1)
    feats_x = px.reshape(-1)
    feats_i = img.reshape(-1)

    c_y = cy.reshape(-1)
    c_x = cx.reshape(-1)
    iy = torch.clamp(c_y.to(torch.int32), 0, h - 1).long()
    ix = torch.clamp(c_x.to(torch.int32), 0, w - 1).long()
    c_i = img[iy, ix]

    n_pix = feats_i.shape[0]
    chunk = max(1, CHUNK_ENTRIES // k)
    step_sq = torch.tensor(step * step, dtype=f32, device=dev)

    def assign(c_y, c_x, c_i):
        lab = torch.empty(n_pix, dtype=torch.int64, device=dev)
        for s in range(0, n_pix, chunk):
            e = min(s + chunk, n_pix)
            dy = feats_y[s:e, None] - c_y[None, :]
            dx = feats_x[s:e, None] - c_x[None, :]
            di = feats_i[s:e, None] - c_i[None, :]
            d = compactness * (dy * dy + dx * dx) / step_sq + di * di
            lab[s:e] = torch.argmin(d, dim=1)  # first index on ties
        return lab

    # The four value rows (ones, y, x, intensity), keyed j * k + label.
    values = torch.cat([torch.ones_like(feats_i), feats_y, feats_x, feats_i])
    rows = torch.arange(0, 4 * k, k, device=dev, dtype=torch.int32).repeat_interleave(n_pix)
    for _ in range(iters):
        lab = assign(c_y, c_x, c_i)
        keys = rows + lab.to(torch.int32).repeat(4)
        cnt, sy, sx, si = dpp.reduce_by_key(keys, values, 4 * k, op="add").reshape(4, k)
        safe = torch.clamp_min(cnt, 1.0)
        c_y = torch.where(cnt > 0, sy / safe, c_y)
        c_x = torch.where(cnt > 0, sx / safe, c_x)
        c_i = torch.where(cnt > 0, si / safe, c_i)
    return assign(c_y, c_x, c_i).to(torch.int32).reshape(h, w)
