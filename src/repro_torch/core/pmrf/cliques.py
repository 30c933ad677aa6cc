"""Maximal clique enumeration for region-adjacency graphs (paper §3.2.1).

Counterpart of ``repro.core.pmrf.cliques``, the same host-side numpy
enumeration over the graph's dense adjacency matrix.

The paper builds MRF neighborhoods on top of the maximal cliques of the
RAG, enumerated with the DPP-based MCE of Lessley et al. [23].  Key
structural fact the enumeration exploits: the RAG of a 2D oversegmentation is
mostly planar, so maximal cliques are small (<= 4 for strictly planar
graphs; spatially fragmented superpixels create occasional denser pockets,
which the enumerator handles by simply iterating deeper).  We enumerate by
canonical extension —
each clique is grown only by vertices larger than its current maximum, so
every k-clique is generated exactly once through its sorted prefix chain —
and emit a clique when its common-neighbor set is empty (the maximality
test).  The iteration depth equals the largest clique size (3-5 here), and
every level is a dense, vectorized membership computation over the
adjacency matrix: this is the Map/Scan/Scatter formulation of MCE
specialized to bounded clique number.

Runs in the initialization phase (untimed in the paper's methodology);
implemented in numpy for clarity, dense-vectorized per level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.pmrf.graph import RegionGraph


@dataclass
class CliqueSet:
    """Maximal cliques, padded to ``width`` with -1."""

    members: np.ndarray  # (n_cliques, width) int32, rows sorted ascending
    sizes: np.ndarray    # (n_cliques,) int32

    @property
    def n_cliques(self) -> int:
        return int(self.members.shape[0])

    @property
    def width(self) -> int:
        return int(self.members.shape[1])


def enumerate_maximal_cliques(
    graph: RegionGraph, max_size: int | None = None, max_frontier: int = 2_000_000
) -> CliqueSet:
    adj = graph.adj
    n = graph.n_regions
    if max_size is None:
        max_size = n  # loop to exhaustion; RAG clique number is small

    maximal: List[np.ndarray] = []  # list of (m_k, k) arrays

    # Level 1: isolated vertices are maximal 1-cliques.
    deg = adj.sum(axis=1)
    isolated = np.nonzero(deg == 0)[0].astype(np.int32)
    if isolated.size:
        maximal.append(isolated[:, None])

    # Level 2 seeds: all edges (u < v).
    cliques = graph.edges.astype(np.int32)  # (m, 2)

    k = 2
    while cliques.size and k <= max_size:
        # Common neighbors of all members: AND of adjacency rows.
        common = np.ones((cliques.shape[0], n), dtype=bool)
        for col in range(k):
            common &= adj[cliques[:, col]]
        is_max = ~common.any(axis=1)
        if is_max.any():
            maximal.append(cliques[is_max])

        # Canonical extension: only w > max(member ids) = last column.
        ext = common.copy()
        col_idx = np.arange(n)[None, :]
        ext &= col_idx > cliques[:, -1:]
        rows, cols = np.nonzero(ext)
        if rows.size == 0:
            break
        if rows.size > max_frontier:
            raise RuntimeError(
                f"clique frontier exploded ({rows.size}) — graph is far from "
                "planar; check the oversegmentation"
            )
        cliques = np.concatenate(
            [cliques[rows], cols[:, None].astype(np.int32)], axis=1
        )
        k += 1

    if not maximal:
        return CliqueSet(
            members=np.zeros((0, 2), np.int32), sizes=np.zeros((0,), np.int32)
        )

    width = max(c.shape[1] for c in maximal)
    rows = sum(c.shape[0] for c in maximal)
    out = np.full((rows, width), -1, dtype=np.int32)
    sizes = np.zeros((rows,), dtype=np.int32)
    r = 0
    for c in maximal:
        out[r : r + c.shape[0], : c.shape[1]] = c
        sizes[r : r + c.shape[0]] = c.shape[1]
        r += c.shape[0]
    return CliqueSet(members=out, sizes=sizes)


def verify_maximal_cliques(graph: RegionGraph, cliques: CliqueSet) -> bool:
    """Oracle check used by tests: every row is a clique, and no row can be
    extended by any vertex (maximality)."""
    adj = graph.adj
    for row, size in zip(cliques.members, cliques.sizes):
        mem = row[:size]
        for i in range(size):
            for j in range(i + 1, size):
                if not adj[mem[i], mem[j]]:
                    return False
        common = np.ones(graph.n_regions, dtype=bool)
        for v in mem:
            common &= adj[v]
        if common.any():
            return False
    return True
