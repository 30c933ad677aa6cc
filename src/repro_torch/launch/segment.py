"""DPP-PMRF segmentation driver: synthetic slices through the session API.

Counterpart of ``repro.launch.segment``.  Generates a corrupted volume
(``--dataset synthetic``: binary porous media, or K phases with
``--labels K``; ``experimental``: the denser mixed-scale structures of the
paper's beamline regime), segments its slices with
``Segmenter.segment_stack`` in ``--mode`` (``static-pallas``, the fused
route, the default; ``static`` or ``faithful``, the paper's primitive
sequence) (``--batch always``: the whole stack as one batched solve under
its joint bucket, in any mode; ``never``: slice by slice; ``auto``: as the
calibrated cost model predicts faster), ``--repeat`` times on one
session, and
prints one JSON line per repeat (wall time, mean ``optimize_s``, the
executable cache's hits and misses), then one per slice of the last
repeat (accuracy against the ground truth, ``em_iters``, ``map_iters``,
``status``, ``init_s``, ``optimize_s``) and a summary line.

``--shards N`` runs the sharded route with one process per shard, under
``torchrun --nproc-per-node N``: each rank joins the default process group
from torchrun's environment (NCCL on the card, each rank on
``cuda:$LOCAL_RANK``; gloo with ``--device cpu``), all ranks solve the
same slices, and only rank 0 prints.  A group that the caller initialised
already is used as it is.  An N that the cost model predicts slower than
its own choice gets a one-line warning on stderr.

``--shards auto`` plans the first slice with a probe session and lets the
cost model (``CostModel.choose_shards``) pick the predicted-fastest count,
printed as one ``{"shards_auto": ...}`` line.  Alone, the candidates are 1
and the counts of (2, 4, 8) that the cards cover; under torchrun, 1 and
the world size (rank 0's choice, broadcast, so every rank takes the same).
A choice this launch cannot run raises with the torchrun command that runs
it.  With ``REPRO_DISABLE_AUTOTUNE=1`` the choice is 1.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.segment --size 512 --grid 32 --labels 2 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.segment --slices 16 --batch always --repeat 3
    PYTHONPATH=src python -m repro_torch.launch.segment --size 64 --grid 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.segment --mode faithful --labels 3
    PYTHONPATH=src python -m repro_torch.launch.segment --mode static --batch always --slices 3
    PYTHONPATH=src python -m repro_torch.launch.segment --dataset experimental --size 192 --grid 16
    PYTHONPATH=src python -m repro_torch.launch.segment --shards auto --slices 1
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.segment --shards 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch import api, planning, resolve_device
from repro_torch.core import metrics as M
from repro_torch.core import synthetic as S

#: Shard counts ``--shards auto`` may pick outside torchrun (the reference's).
AUTO_SHARDS = (2, 4, 8)


def _shards(value: str) -> Optional[int]:
    """``--shards``: a count >= 1, or ``None`` for ``auto``."""
    if value == "auto":
        return None
    n = int(value)
    if n < 1:
        raise ValueError(f"--shards must be >= 1, got {n}")
    return n


def _world_size() -> int:
    """Ranks of this launch: torchrun's ``WORLD_SIZE`` (or a group the caller
    made), 1 alone."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _candidates(device: torch.device, world: int, forced: Optional[int]) -> List[int]:
    """The shard counts the cost model chooses among: under torchrun 1 and
    the world size; alone 1 and the counts of ``AUTO_SHARDS`` the cards
    cover (the host counts as one device); an explicit count besides."""
    if world > 1:
        cands = {1, world}
    else:
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        cands = {1} | {s for s in AUTO_SHARDS if s <= cards}
    return sorted(cands | {forced or 1})


def _choose_shards(args, device: torch.device, vol, forced: Optional[int]) -> int:
    """Plan the first slice with a probe session and ask the cost model for
    the shard count; ``--shards auto`` prints the decision (rank 0) and
    takes it, an explicit count is taken with ``warn_if_forced``'s warning.
    Every rank plans the same slice, and under torchrun takes rank 0's
    choice.  An explicit count with nothing to compare it to plans
    nothing."""
    world = _world_size()
    candidates = _candidates(device, world, forced)
    if forced is not None and candidates == [forced]:
        return forced
    config = _config(args, shards=1)
    probe = api.Segmenter(config, device=device)
    plan = probe.plan(vol.images[0])
    decision = probe.cost_model().choose_shards(
        mode=config.mode, bucket=plan.bucket, candidates=candidates,
        n_labels=config.n_labels, precision=config.precision,
        max_em_iters=config.max_em_iters, max_map_iters=config.max_map_iters,
    )
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if forced is not None:
        warning = decision.warn_if_forced(forced)
        if warning is not None and rank0:
            print(f"warning: {warning}", file=sys.stderr)
        return forced
    shards = 1 if planning.autotune_disabled() else decision.shards
    if world > 1:
        # Rank 0's choice on every rank: the ranks plan alike, but a
        # prediction on the edge of a tie must not part them.
        choice = torch.tensor([shards], dtype=torch.int64,
                              device=device if device.type == "cuda" else "cpu")
        dist.broadcast(choice, src=0)
        shards = int(choice.item())
    if rank0:
        print(json.dumps({"shards_auto": decision.as_dict()}))
    if shards not in (1, world):
        raise RuntimeError(
            f"--shards auto chose {shards} shards, which run one process each: launch "
            f"`torchrun --nproc-per-node {shards} -m repro_torch.launch.segment --shards "
            f"{shards}` with the same arguments"
        )
    return shards


def _config(args, shards: int) -> api.ExecutionConfig:
    return api.ExecutionConfig(
        mode=args.mode,
        n_labels=args.labels,
        init=args.init,
        overseg_grid=(args.grid, args.grid),
        shards=shards,
    )


def _volume(args, device: torch.device):
    shape = (args.size, args.size)
    if args.labels > 2:
        return S.make_kary_volume(
            seed=args.seed, n_slices=args.slices, shape=shape, n_phases=args.labels,
            device=device,
        )
    if args.dataset == "experimental":
        return S.make_experimental_like_volume(
            seed=args.seed, n_slices=args.slices, shape=shape, device=device
        )
    return S.make_synthetic_volume(seed=args.seed, n_slices=args.slices, shape=shape, device=device)


def _join_group(device: torch.device) -> bool:
    """Join the default process group from torchrun's environment unless
    one exists; returns True when this call created it."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "--shards N > 1 runs one process per shard: launch it with "
            "`torchrun --nproc-per-node N -m repro_torch.launch.segment --shards N`"
        )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slices", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--grid", type=int, default=32, help="oversegmentation grid")
    ap.add_argument("--labels", type=int, default=2, metavar="K")
    ap.add_argument("--mode", choices=("static", "faithful", "static-pallas"),
                    default="static-pallas", help="the MAP iteration (em.MODES)")
    ap.add_argument("--init", choices=("random", "quantile"), default="quantile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--shards", default="1", metavar="N",
                    help="ranks of the sharded route, one process each under torchrun; "
                         "'auto': the calibrated cost model's choice")
    ap.add_argument("--dataset", choices=("synthetic", "experimental"), default="synthetic")
    ap.add_argument("--batch", choices=("auto", "always", "never"), default="auto",
                    help="segment_stack's batching of the slices")
    ap.add_argument("--repeat", type=int, default=1, help="stack solves on one session")
    args = ap.parse_args(argv)
    if args.labels > 2 and args.dataset == "experimental":
        ap.error("--labels K>2 generates its own K-phase volume and cannot be "
                 "combined with --dataset experimental")
    forced = _shards(args.shards)

    device = resolve_device(args.device)
    created = False
    if (forced or 1) > 1 or (forced is None and _world_size() > 1):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        created = _join_group(device)
    try:
        vol = _volume(args, device)
        return _run(args, device, _choose_shards(args, device, vol, forced), vol)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, device: torch.device, shards: int, vol) -> List[dict]:
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    sess = api.Segmenter(_config(args, shards), device=device)
    results = None
    for r in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        results, mean_opt = sess.segment_stack(vol.images, seed=args.seed, batch=args.batch)
        if rank0:
            print(json.dumps({"repeat": r, "wall_s": time.perf_counter() - t0,
                              "mean_optimize_s": mean_opt, "cache": sess.stats.as_dict()}))
    rows = []
    for i, res in enumerate(results):
        gt = vol.ground_truth[i]
        if args.labels > 2:
            acc = M.multiclass_accuracy(res.segmentation, gt, args.labels)
        else:
            acc = M.evaluate(res.segmentation, gt).accuracy
        row = {
            "slice": i,
            "accuracy": acc,
            "em_iters": res.em_iters,
            "map_iters": res.map_iters,
            "status": res.status,
            "init_s": res.init_seconds,
            "optimize_s": res.optimize_seconds,
            "device": str(device),
            "shards": shards,
        }
        if rank0:
            print(json.dumps(row))
        rows.append(row)
    if rank0:
        print(json.dumps({
            "mean_accuracy": float(sum(r["accuracy"] for r in rows) / len(rows)),
            "mean_optimize_s": float(sum(r["optimize_s"] for r in rows) / len(rows)),
            "labels": args.labels,
            "dataset": args.dataset,
            "mode": args.mode,
            "batch": args.batch,
            "backend": sess.config.resolved_backend(device),
            "shards": shards,
            "executables_cached": len(sess.cache_keys),
        }))
    return rows


if __name__ == "__main__":
    main()
