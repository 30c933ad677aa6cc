"""Distributed (multi-process) DPP-PMRF on ``torch.distributed``.

Counterpart of ``repro.core.pmrf.distributed``: the hybrid
distributed-memory PMRF the paper lists as future work (section 5, [15]),
with no EM loop of its own.  The one driver (``em._em_driver``) runs on
every rank under a sharded ``collectives.ReduceCtx``; this module only

  1. block-partitions the hood elements over the ranks
     (:func:`partition_hoods`, on the host; its shapes depend only on the
     capacity and the shard count), and
  2. runs the driver on this rank's block (:func:`run_em_sharded`).

Ranks are processes, one per device (``torchrun --nproc-per-node N``);
the process group is the JAX mesh axis's counterpart.  Labels and
parameters are small and the same on every rank, so every rank takes the
same EM trajectory: sharded labels equal single-device labels, and
energies agree to the order in which the partial sums are added.

Partitioning is by element block, not by whole neighbourhood: hood sums
use the global hood id space and an all-reduce, so a neighbourhood may
straddle ranks and the blocks are balanced by construction.  The faithful
mode's label-replication arrays are relocalised per shard, so that its
per-element SortByKey + ReduceByKey(Min) would stay rank-local.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pmrf import collectives
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as E
from repro_torch.core.pmrf.em import EMConfig, EMResult
from repro_torch.core.pmrf.hoods import Hoods

Tensor = torch.Tensor


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])


def partition_hoods(hoods: Hoods, n_shards: int) -> Hoods:
    """Prepare a ``Hoods`` for block-partitioned execution over
    ``n_shards`` ranks.

    Element arrays are padded so that the capacity splits into ``n_shards``
    blocks of ``block = ceil(capacity / n_shards)`` lanes (padding lanes
    carry the usual sentinels and ``valid == False``).  The replication
    arrays are relocalised: lanes ``[s * 2 * block, (s + 1) * 2 * block)``
    hold exactly the rep lanes whose ``old_index`` falls in element block
    ``s``, with ``old_index`` rebased to the block (each valid element has
    two rep lanes, so ``2 * block`` lanes per shard always suffice).
    ``vertex`` and ``hood_id`` keep their global ids.  ``sizes`` and
    ``offsets`` pass through unchanged; they do not describe the padded
    layout.  The result is only meaningful as input to
    :func:`run_em_sharded`.  With ``n_shards <= 1`` it is ``hoods``.
    """
    if n_shards <= 1:
        return hoods
    dev = hoods.vertex.device
    cap = hoods.capacity
    block = -(-cap // n_shards)
    cap_pad = block * n_shards
    n_hoods, n_regions = hoods.n_hoods, hoods.n_regions

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    vertex = _pad_to(host(hoods.vertex, np.int32), cap_pad, n_regions)
    hood_id = _pad_to(host(hoods.hood_id, np.int32), cap_pad, n_hoods)
    valid = _pad_to(host(hoods.valid, bool), cap_pad, False)

    rep_valid = host(hoods.rep_valid, bool)
    rep_old = host(hoods.rep_old_index, np.int64)
    rep_test = host(hoods.rep_test_label, np.int32)
    rep_hood = host(hoods.rep_hood_id, np.int32)

    out_old = np.full((2 * cap_pad,), block - 1, np.int32)
    out_test = np.zeros((2 * cap_pad,), np.int32)
    out_hood = np.full((2 * cap_pad,), n_hoods, np.int32)
    out_valid = np.zeros((2 * cap_pad,), bool)

    lanes = np.nonzero(rep_valid)[0]
    if lanes.size:
        shard = rep_old[lanes] // block
        order = np.argsort(shard, kind="stable")
        lanes, shard = lanes[order], shard[order]
        counts = np.bincount(shard, minlength=n_shards)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(lanes.size) - starts[shard]
        if int(rank.max()) >= 2 * block:
            raise AssertionError(
                "replication overflow: an element block received more than "
                "2*block rep lanes; hoods invariant violated"
            )
        pos = shard * (2 * block) + rank
        out_old[pos] = (rep_old[lanes] - shard * block).astype(np.int32)
        out_test[pos] = rep_test[lanes]
        out_hood[pos] = rep_hood[lanes]
        out_valid[pos] = True

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    return Hoods(
        vertex=dev_t(vertex),
        hood_id=dev_t(hood_id),
        valid=dev_t(valid),
        sizes=hoods.sizes,
        offsets=hoods.offsets,
        n_hoods=n_hoods,
        n_regions=n_regions,
        n_elements=hoods.n_elements,
        rep_old_index=dev_t(out_old),
        rep_test_label=dev_t(out_test),
        rep_hood_id=dev_t(out_hood),
        rep_valid=dev_t(out_valid),
    )


def _group(group: Optional[dist.ProcessGroup]) -> dist.ProcessGroup:
    if not dist.is_initialized():
        raise RuntimeError(
            "the sharded route needs an initialised torch.distributed process "
            "group (one rank per shard, e.g. under torchrun)"
        )
    return dist.group.WORLD if group is None else group


def _check_same_problem(hoods: Hoods, labels0: Tensor, group: dist.ProcessGroup) -> None:
    """Raise on every rank unless all ranks hold the same partitioned
    problem.  Ranks that plan on their own could disagree, and collectives
    over tensors of different shapes would hang instead of failing."""
    fingerprint = torch.stack([
        torch.tensor(hoods.capacity, device=labels0.device),
        torch.tensor(hoods.n_hoods, device=labels0.device),
        torch.tensor(hoods.n_regions, device=labels0.device),
        hoods.hood_id.long().sum(),
        (hoods.vertex.long() * torch.arange(1, hoods.capacity + 1, device=labels0.device)).sum(),
        labels0.long().sum(),
    ])
    lo, hi = fingerprint.clone(), fingerprint.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise ValueError(
            "the ranks hold different problems (capacity, hoods, regions or "
            "element ids differ); every rank must solve the same plan"
        )


def run_em_sharded(
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    *,
    config: EMConfig,
    group: Optional[dist.ProcessGroup] = None,
) -> EMResult:
    """Run the EM driver on this rank's element block of ``hoods``.

    Every rank of ``group`` (``None``: the default group) calls this with
    the same arguments; ``hoods`` must come from :func:`partition_hoods`
    for the group's size.  Rank ``r`` solves element block ``r`` and the
    replication lanes relocalised to it; the block keeps global
    ``vertex``/``hood_id`` and carries no ``sizes``/``offsets``.  Ranks
    whose problems differ raise ``ValueError`` before the first collective
    of the solve.  Returns the same result on every rank.
    """
    em_mod.validate_config(config)
    group = _group(group)
    _check_same_problem(hoods, labels0, group)  # first: every rank then raises alike
    n_shards = dist.get_world_size(group)
    cap = hoods.capacity
    if cap % n_shards:
        raise ValueError(
            f"hoods capacity {cap} not divisible by {n_shards} shards; "
            "call partition_hoods(hoods, n_shards) first"
        )
    block = cap // n_shards
    rank = dist.get_rank(group)
    e = slice(rank * block, (rank + 1) * block)
    r = slice(2 * rank * block, 2 * (rank + 1) * block)
    local = Hoods(
        vertex=hoods.vertex[e],
        hood_id=hoods.hood_id[e],
        valid=hoods.valid[e],
        sizes=None,
        offsets=None,
        n_hoods=hoods.n_hoods,
        n_regions=hoods.n_regions,
        n_elements=-1,
        rep_old_index=hoods.rep_old_index[r],
        rep_test_label=hoods.rep_test_label[r],
        rep_hood_id=hoods.rep_hood_id[r],
        rep_valid=hoods.rep_valid[r],
    )
    ctx = collectives.ReduceCtx(group=group)
    return em_mod._em_driver(local, model, labels0, mu0, sigma0, config, ctx)


def distributed_em(
    hoods: Hoods,
    model: E.EnergyModel,
    labels0: Tensor,
    mu0: Tensor,
    sigma0: Tensor,
    group: Optional[dist.ProcessGroup] = None,
    config: EMConfig = EMConfig(),
) -> EMResult:
    """Partition ``hoods`` over the ranks of ``group`` (``None``: the
    default group) and run EM sharded.  The session layer calls the two
    steps apart, so that it can keep the partition of a plan."""
    parts = partition_hoods(hoods, dist.get_world_size(_group(group)))
    return run_em_sharded(parts, model, labels0, mu0, sigma0, config=config, group=group)
