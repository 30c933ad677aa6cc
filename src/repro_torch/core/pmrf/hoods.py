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
the EM-tick kernel walks.  It also builds the paper's label-replication
arrays (testLabel, oldIndex, hoodId: the memory-free "repHoods" Gather),
which ``distributed.partition_hoods`` relocalises per shard.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import dpp
from repro_torch.core.pmrf.cliques import CliqueSet
from repro_torch.core.pmrf.graph import RegionGraph


@dataclass
class Hoods:
    """Flat neighborhood arrays, padded to ``capacity``.

    Padding lanes carry ``vertex == n_regions`` / ``hood_id == n_hoods`` so
    gathers stay in bounds against sentinel-extended region arrays.  The
    shard-local ``Hoods`` of the sharded route holds one element block and
    no ``sizes``/``offsets`` (``None``): its hoods are not whole runs.
    """

    vertex: torch.Tensor             # (capacity,) int32: vertex id per hood element
    hood_id: torch.Tensor            # (capacity,) int32: neighborhood id per element
    valid: torch.Tensor              # (capacity,) bool
    sizes: Optional[torch.Tensor]    # (n_hoods,) int32
    offsets: Optional[torch.Tensor]  # (n_hoods + 1,) int32, over the packed prefix
    n_hoods: int
    n_regions: int
    n_elements: int                  # valid-element count
    # Label replication (paper layout: per hood, its label-0 block then its
    # label-1 block), each (2 * capacity,):
    rep_old_index: torch.Tensor      # int32 element index per rep lane
    rep_test_label: torch.Tensor     # int32 label the lane tests
    rep_hood_id: torch.Tensor        # int32, n_hoods on unused lanes
    rep_valid: torch.Tensor          # bool

    @property
    def capacity(self) -> int:
        return int(self.vertex.shape[-1])


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
    hood_offsets = dpp.counts_to_offsets(sizes)
    rep = _build_replication(valid, sizes, hood_offsets, c, int(vertex.shape[0]))
    return Hoods(
        vertex=vertex,
        hood_id=torch.where(valid, hood_id, c).to(i32),
        valid=valid,
        sizes=sizes,
        offsets=hood_offsets,
        n_hoods=c,
        n_regions=n,
        n_elements=int(valid.sum()),
        rep_old_index=rep[0],
        rep_test_label=rep[1],
        rep_hood_id=rep[2],
        rep_valid=rep[3],
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

    i32 = torch.int32
    valid = pad1(h.valid, False, capacity)
    rep_valid = pad1(h.rep_valid, False, 2 * capacity)
    return Hoods(
        vertex=torch.where(valid, pad1(h.vertex, 0, capacity), n_regions).to(i32),
        hood_id=torch.where(valid, pad1(h.hood_id, 0, capacity), n_hoods).to(i32),
        valid=valid,
        sizes=pad1(h.sizes, 0, n_hoods),
        offsets=torch.cat([h.offsets, h.offsets[-1:].expand(n_hoods - h.n_hoods)]),
        n_hoods=n_hoods,
        n_regions=n_regions,
        n_elements=n_elements,
        rep_old_index=torch.where(
            rep_valid, pad1(h.rep_old_index, 0, 2 * capacity), capacity - 1
        ).to(i32),
        rep_test_label=torch.where(rep_valid, pad1(h.rep_test_label, 0, 2 * capacity), 0).to(i32),
        rep_hood_id=torch.where(rep_valid, pad1(h.rep_hood_id, 0, 2 * capacity), n_hoods).to(i32),
        rep_valid=rep_valid,
    )


def stack_hoods(hoods: Sequence[Hoods]) -> Hoods:
    """Hoods of one bucket (equal capacity, hood and region counts) stacked
    on a leading lane axis, as the batched driver takes them; their
    element counts may differ (``n_elements`` -1, the reference's "mixed
    stack")."""
    first = hoods[0]
    shape = (first.capacity, first.n_hoods, first.n_regions)
    if any((h.capacity, h.n_hoods, h.n_regions) != shape for h in hoods):
        raise ValueError(f"cannot stack hoods of different buckets (the first is {shape}); "
                         "pad them with pad_hoods first")
    out = {}
    for f in fields(Hoods):
        vals = [getattr(h, f.name) for h in hoods]
        if isinstance(vals[0], torch.Tensor):
            out[f.name] = torch.stack(vals)
        elif f.name == "n_elements":
            out[f.name] = vals[0] if len(set(vals)) == 1 else -1
        else:
            out[f.name] = vals[0]
    return Hoods(**out)


def _build_replication(
    valid: torch.Tensor,
    sizes: torch.Tensor,
    hood_offsets: torch.Tensor,
    n_hoods: int,
    h_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's testLabel / oldIndex / hoodId arrays of size 2 * h_pad.

    Hood ``h`` of size ``s`` at packed offset ``o`` owns rep lanes
    ``[2o, 2o+s)`` (its elements with testLabel 0) and ``[2o+s, 2o+2s)``
    (testLabel 1), the worked example of the paper's section 3.2.2.
    ``oldIndex`` counts in the packed (valid-only) order, so the
    packed-to-padded map is folded in and ``rep_old_index`` indexes the
    padded arrays.  Returns ``(old_index, test_label, hood_id, valid)``.
    """
    dev = valid.device
    i32 = torch.int32
    # The padded index of each packed element (an exclusive scan of valid).
    lanes = torch.arange(h_pad, dtype=i32, device=dev)
    vi = valid.to(i32)
    packed_pos = (torch.cumsum(vi, 0) - vi).long()
    pad_of_packed = torch.full((h_pad,), h_pad - 1, dtype=i32, device=dev)
    pad_of_packed[packed_pos[valid]] = lanes[valid]

    rep_hood, rep_rank = dpp.expand_with_rank((2 * sizes).to(i32), 2 * h_pad)
    rep_hood, rep_rank = rep_hood.long(), rep_rank.long()
    lane_valid = rep_hood < n_hoods
    safe_hood = torch.clamp_max(rep_hood, n_hoods - 1)
    s = sizes.long()[safe_hood]
    o = hood_offsets.long()[safe_hood]
    second = rep_rank >= s
    packed_idx = torch.clamp_max(o + torch.where(second, rep_rank - s, rep_rank), h_pad - 1)
    old_index = pad_of_packed[packed_idx]
    return (
        torch.where(lane_valid, old_index, h_pad - 1).to(i32),
        torch.where(lane_valid, second.to(i32), 0).to(i32),
        torch.where(lane_valid, rep_hood, n_hoods).to(i32),
        lane_valid,
    )
