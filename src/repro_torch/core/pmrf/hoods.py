"""k=1 neighborhood construction from maximal cliques (paper §3.2.2).

Counterpart of ``repro.core.pmrf.hoods``: the paper's four data-parallel
steps on top of the DPP layer, on the graph's device.

  1. **Find Neighbors** (Map): per clique-member slot, its 1-hop degree.
  2. **Count Neighbors** (Scan): total candidate capacity.
  3. **Get Neighbors** (Map over the expanded lanes): candidate
     (cliqueId, vertexId) elements, minus neighbors inside the clique.
  4. **Remove Duplicate Neighbors** (SortByKey + Unique) over packed
     (cliqueId, vertexId) keys.

The sort leaves the elements ordered by (hood, vertex), valid elements
first: hood ``h`` owns elements ``offsets[h]:offsets[h+1]``, the layout
the EM-tick kernel walks.  The reference also builds the paper's
label-replication arrays (``rep_*``) for the faithful mode; that mode is
not ported yet, and neither are they.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import dpp
from repro_torch.core.pmrf.cliques import CliqueSet
from repro_torch.core.pmrf.graph import RegionGraph


@dataclass
class Hoods:
    """Flat neighborhood arrays, padded to ``capacity``.

    Padding lanes carry ``vertex == n_regions`` / ``hood_id == n_hoods`` so
    gathers stay in bounds against sentinel-extended region arrays.
    """

    vertex: torch.Tensor   # (capacity,) int32: vertex id per hood element
    hood_id: torch.Tensor  # (capacity,) int32: neighborhood id per element
    valid: torch.Tensor    # (capacity,) bool
    sizes: torch.Tensor    # (n_hoods,) int32
    offsets: torch.Tensor  # (n_hoods + 1,) int32, over the packed prefix
    n_hoods: int
    n_regions: int
    n_elements: int        # valid-element count

    @property
    def capacity(self) -> int:
        return int(self.vertex.shape[0])


def build_hoods(graph: RegionGraph, cliques: CliqueSet) -> Hoods:
    """Neighborhoods (clique members plus their 1-hop neighbors) of every
    maximal clique, on the device of ``graph.region_mean``."""
    dev = graph.region_mean.device
    n = graph.n_regions
    c = cliques.n_cliques
    w = cliques.width
    if c == 0:
        raise ValueError("no cliques — empty graph?")
    i32 = torch.int32

    members = torch.as_tensor(cliques.members, device=dev)          # (C, W)
    members_flat = members.reshape(-1)                               # (C*W,)
    clique_of_slot = torch.arange(c, dtype=i32, device=dev).repeat_interleave(w)
    valid_slot = members_flat >= 0
    n_slots = c * w

    offsets = torch.as_tensor(graph.csr_offsets, device=dev).long()
    neighbors = torch.as_tensor(graph.csr_neighbors, device=dev)
    deg = offsets[1:] - offsets[:-1]
    safe_member = torch.where(valid_slot, members_flat, 0).long()

    # Step 1: Find Neighbors (Map): per-slot neighbor counts.
    slot_counts = torch.where(valid_slot, deg[safe_member], 0).to(i32)

    # Step 2: Count Neighbors (Scan): all neighbor slots + the members.
    neighbor_capacity = int(slot_counts.sum())

    # Step 3: Get Neighbors (Map over expanded lanes).
    src_slot, rank = dpp.expand_with_rank(slot_counts, neighbor_capacity)
    lane_valid = src_slot < n_slots
    safe_slot = torch.clamp_max(src_slot, n_slots - 1).long()
    v = safe_member[safe_slot]
    nb_idx = torch.clamp_max(offsets[v] + rank, max(neighbors.shape[0] - 1, 0))
    nb = neighbors[nb_idx]
    cid = clique_of_slot[safe_slot]
    # Exclude neighbors that are members of the same clique.
    nb_in_clique = torch.any(members[cid.long()] == nb[:, None], dim=1)
    cand_valid_nb = lane_valid & ~nb_in_clique

    span = n + 1
    sentinel = c * span + n  # decodes to (hood_id=c, vertex=n)
    key_nb = torch.where(
        cand_valid_nb, dpp.compound_key(cid, nb, span, major_span=c + 1), sentinel
    )
    key_mem = torch.where(
        valid_slot,
        dpp.compound_key(clique_of_slot, safe_member, span, major_span=c + 1),
        sentinel,
    )
    keys = torch.cat([key_mem, key_nb])

    # Step 4: Remove Duplicate Neighbors (SortByKey + Unique).
    (sorted_keys,) = dpp.sort_by_key(keys)
    uniq, count = dpp.unique_(sorted_keys, fill=sentinel)
    lane = torch.arange(uniq.shape[0], device=dev)
    uniq = torch.where((lane < count) & (uniq != sentinel), uniq, sentinel)

    hood_id = (uniq // span).to(i32)
    vertex = (uniq % span).to(i32)
    valid = uniq != sentinel

    sizes = dpp.reduce_by_key(
        torch.where(valid, hood_id, c), valid.to(i32), c + 1, op="add"
    )[:c]
    return Hoods(
        vertex=vertex,
        hood_id=torch.where(valid, hood_id, c).to(i32),
        valid=valid,
        sizes=sizes,
        offsets=dpp.counts_to_offsets(sizes),
        n_hoods=c,
        n_regions=n,
        n_elements=int(valid.sum()),
    )


def pad_hoods(
    h: Hoods,
    *,
    capacity: int,
    n_hoods: int,
    n_regions: int,
    n_elements: Optional[int] = None,
) -> Hoods:
    """Pad a ``Hoods`` to a larger (capacity, n_hoods, n_regions) bucket.

    Padding lanes carry the bucket's sentinels and ``valid == False``;
    phantom hoods (ids >= the real hood count) are empty runs at the end
    of ``offsets``, so every keyed reduction is unchanged.
    """
    if capacity < h.capacity or n_hoods < h.n_hoods or n_regions < h.n_regions:
        raise ValueError(
            f"bucket ({capacity}, {n_hoods}, {n_regions}) smaller than hoods "
            f"({h.capacity}, {h.n_hoods}, {h.n_regions})"
        )
    if n_elements is None:
        n_elements = h.n_elements
    if (capacity, n_hoods, n_regions, n_elements) == (
        h.capacity, h.n_hoods, h.n_regions, h.n_elements,
    ):
        return h

    def pad1(x, fill, total):
        out = torch.full((total,), fill, dtype=x.dtype, device=x.device)
        out[: x.shape[0]] = x
        return out

    valid = pad1(h.valid, False, capacity)
    return Hoods(
        vertex=torch.where(valid, pad1(h.vertex, 0, capacity), n_regions).to(torch.int32),
        hood_id=torch.where(valid, pad1(h.hood_id, 0, capacity), n_hoods).to(torch.int32),
        valid=valid,
        sizes=pad1(h.sizes, 0, n_hoods),
        offsets=torch.cat([h.offsets, h.offsets[-1:].expand(n_hoods - h.n_hoods)]),
        n_hoods=n_hoods,
        n_regions=n_regions,
        n_elements=n_elements,
    )
