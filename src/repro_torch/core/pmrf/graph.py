"""Region-adjacency graph from an oversegmentation (paper §3.2.1).

Counterpart of ``repro.core.pmrf.graph``.  Edge detection and
deduplication run in numpy on the host, as in the reference (this is the
untimed initialization phase); the per-region statistics are ReduceByKey
over the pixels on the label map's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import dpp


@dataclass
class RegionGraph:
    """CSR + dense adjacency (host numpy) + per-region statistics (tensors
    on the problem's device)."""

    n_regions: int
    edges: np.ndarray          # (E, 2) int32, u < v, deduped
    csr_offsets: np.ndarray    # (n_regions + 1,) int32
    csr_neighbors: np.ndarray  # (2E,) int32
    adj: np.ndarray            # (n_regions, n_regions) bool, zero diagonal
    region_mean: torch.Tensor  # (n_regions,) float32: MRF data term
    region_size: torch.Tensor  # (n_regions,) float32: pixel counts
    max_degree: int


def region_stats(
    image: torch.Tensor, labels: torch.Tensor, n_regions: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-region mean intensity + pixel count via ReduceByKey."""
    flat_img = image.reshape(-1).to(torch.float32)
    flat_lab = labels.reshape(-1).to(torch.int32)
    sums = dpp.reduce_by_key(flat_lab, flat_img, n_regions, op="add")
    counts = dpp.reduce_by_key(flat_lab, torch.ones_like(flat_img), n_regions, op="add")
    return sums / torch.clamp_min(counts, 1.0), counts


def build_region_graph(
    image: torch.Tensor, labels: torch.Tensor, n_regions: int
) -> RegionGraph:
    """Build the RAG from a pixel label map (boundary pairs -> sorted
    unique edge keys -> dense adjacency + CSR)."""
    lab = labels.detach().cpu().numpy().astype(np.int64)

    pairs_h = np.stack([lab[:, :-1].ravel(), lab[:, 1:].ravel()], axis=1)
    pairs_v = np.stack([lab[:-1, :].ravel(), lab[1:, :].ravel()], axis=1)
    pairs = np.concatenate([pairs_h, pairs_v], axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    u = np.minimum(pairs[:, 0], pairs[:, 1])
    v = np.maximum(pairs[:, 0], pairs[:, 1])
    key = np.unique(u * n_regions + v)  # SortByKey + Unique
    eu = (key // n_regions).astype(np.int32)
    ev = (key % n_regions).astype(np.int32)
    edges = np.stack([eu, ev], axis=1)

    adj = np.zeros((n_regions, n_regions), dtype=bool)
    adj[eu, ev] = True
    adj[ev, eu] = True

    deg = adj.sum(axis=1).astype(np.int32)
    offsets = np.zeros(n_regions + 1, dtype=np.int32)
    np.cumsum(deg, out=offsets[1:])
    neighbors = np.nonzero(adj)[1].astype(np.int32)  # row-major = CSR order

    mean, size = region_stats(image, labels, n_regions)
    return RegionGraph(
        n_regions=n_regions,
        edges=edges,
        csr_offsets=offsets,
        csr_neighbors=neighbors,
        adj=adj,
        region_mean=mean,
        region_size=size,
        max_degree=int(deg.max(initial=0)),
    )
