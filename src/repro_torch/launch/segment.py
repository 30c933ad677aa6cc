"""DPP-PMRF segmentation driver: synthetic slices through the session API.

Counterpart of ``repro.launch.segment``.  Generates a corrupted synthetic
volume (binary porous media, or K phases with ``--labels K``), segments
its slices with ``Segmenter.segment_stack`` in mode ``static-pallas``
(``--batch always``: the whole stack as one batched solve under its joint
bucket; ``never``: slice by slice; ``auto``: batched on the card when the
slices' capacities are within 2x), ``--repeat`` times on one session, and
prints one JSON line per repeat (wall time, mean ``optimize_s``, the
executable cache's hits and misses), then one per slice of the last
repeat (accuracy against the ground truth, ``em_iters``, ``map_iters``,
``status``, ``init_s``, ``optimize_s``) and a summary line.

``--shards N`` runs the sharded route with one process per shard, under
``torchrun --nproc-per-node N``: each rank joins the default process group
from torchrun's environment (NCCL on the card, each rank on
``cuda:$LOCAL_RANK``; gloo with ``--device cpu``), all ranks solve the
same slices, and only rank 0 prints.  A group that the caller initialised
already is used as it is.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.segment --size 512 --grid 32 --labels 2 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.segment --slices 16 --batch always --repeat 3
    PYTHONPATH=src python -m repro_torch.launch.segment --size 64 --grid 8 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.segment --shards 2
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch import api, resolve_device
from repro_torch.core import metrics as M
from repro_torch.core import synthetic as S


def _shards(value: str) -> int:
    if value == "auto":
        raise NotImplementedError(
            "--shards auto picks the shard count from the calibrated cost "
            "model, which is not ported to repro_torch yet (ROADMAP.md Queue 1, "
            "'planning/'); pass a number"
        )
    n = int(value)
    if n < 1:
        raise ValueError(f"--shards must be >= 1, got {n}")
    return n


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
    ap.add_argument("--init", choices=("random", "quantile"), default="quantile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--shards", default="1", metavar="N",
                    help="ranks of the sharded route, one process each under torchrun")
    ap.add_argument("--batch", choices=("auto", "always", "never"), default="auto",
                    help="segment_stack's batching of the slices")
    ap.add_argument("--repeat", type=int, default=1, help="stack solves on one session")
    args = ap.parse_args(argv)
    shards = _shards(args.shards)

    device = resolve_device(args.device)
    created = False
    if shards > 1:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        created = _join_group(device)
    try:
        return _run(args, device, shards)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, device: torch.device, shards: int) -> List[dict]:
    rank0 = shards == 1 or dist.get_rank() == 0
    shape = (args.size, args.size)
    if args.labels > 2:
        vol = S.make_kary_volume(
            seed=args.seed, n_slices=args.slices, shape=shape, n_phases=args.labels,
            device=device,
        )
    else:
        vol = S.make_synthetic_volume(
            seed=args.seed, n_slices=args.slices, shape=shape, device=device
        )
    sess = api.Segmenter(
        api.ExecutionConfig(
            n_labels=args.labels,
            init=args.init,
            overseg_grid=(args.grid, args.grid),
            shards=shards,
        ),
        device=device,
    )
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
            "batch": args.batch,
            "backend": sess.config.resolved_backend(device),
            "shards": shards,
            "executables_cached": len(sess.cache_keys),
        }))
    return rows


if __name__ == "__main__":
    main()
