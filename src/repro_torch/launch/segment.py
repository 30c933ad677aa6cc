"""DPP-PMRF segmentation driver: synthetic slices through the session API.

Counterpart of ``repro.launch.segment``.  Generates a corrupted synthetic
volume (binary porous media, or K phases with ``--labels K``), segments
each slice with ``Segmenter`` in mode ``static-pallas`` and prints one
JSON line per slice: accuracy against the ground truth, ``em_iters``,
``map_iters``, ``status``, ``init_s`` and ``optimize_s``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.segment --size 512 --grid 32 --labels 2 --seed 0
    PYTHONPATH=src python -m repro_torch.launch.segment --size 64 --grid 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch import api, resolve_device
from repro_torch.core import metrics as M
from repro_torch.core import synthetic as S


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slices", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--grid", type=int, default=32, help="oversegmentation grid")
    ap.add_argument("--labels", type=int, default=2, metavar="K")
    ap.add_argument("--init", choices=("random", "quantile"), default="quantile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
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
        ),
        device=device,
    )
    rows = []
    for i in range(args.slices):
        res = sess.segment(vol.images[i], seed=args.seed)
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
        }
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
