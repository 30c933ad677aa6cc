"""Segment a multi-slice volume on the PyTorch/CUDA port (the paper's 3D as a
stack of 2D slices) and reproduce the verification of paper §4.2: per-slice
precision, recall, accuracy and porosity against ground truth, for the
synthetic and the experimental-like datasets.

The counterpart of ``segment_volume.py`` on ``repro_torch``.  Each dataset's
slices go through ``Segmenter.segment_stack(batch="always")``: one batched
launch of the fused tick kernel per lockstep MAP iteration, on the card.
The volumes are made on the host from their seeds, so the card and the CPU
see the same pixels.

Run:  PYTHONPATH=src python examples/torch_segment_volume.py              # on the card
      PYTHONPATH=src python examples/torch_segment_volume.py --device cpu # plain PyTorch on the host
"""

import argparse

import numpy as np

from repro_torch import api, resolve_device
from repro_torch.core import metrics, synthetic

DATASETS = (
    ("synthetic (NGCF-like porous media)",
     lambda size: synthetic.make_synthetic_volume(seed=0, n_slices=2, shape=(size, size), device="cpu")),
    ("experimental-like (denser structures)",
     lambda size: synthetic.make_experimental_like_volume(seed=1, n_slices=2, shape=(size, size), device="cpu")),
)


def run(device=None, size: int = 96, log=print) -> dict:
    """Both datasets through one session on ``device`` (None: the card):
    every slice of a dataset shares a bucket, so the stack runs as one
    batched solve, and the second dataset reuses any executable whose
    bucket matches."""
    dev = resolve_device(device)
    config = api.ExecutionConfig(overseg_grid=(12, 12), init="quantile")
    session = api.Segmenter(config, device=dev)
    out = {"config": config, "session": session, "datasets": []}
    for name, make in DATASETS:
        vol = make(size)
        log(f"== {name} ==")
        results, _ = session.segment_stack([im.to(dev) for im in vol.images], batch="always")
        rows = []
        for i, res in enumerate(results):
            m = metrics.evaluate(res.segmentation, vol.ground_truth[i])
            rows.append(m.as_dict())
            log(f"  slice {i}: acc={m.accuracy:.3f} prec={m.precision:.3f} "
                f"rec={m.recall:.3f} porosity={m.porosity:.3f} "
                f"(true {m.porosity_true:.3f})  "
                f"[{res.em_iters} EM iters, {res.optimize_seconds:.2f}s]")
        log(f"  mean accuracy: {np.mean([r['accuracy'] for r in rows]):.3f}  "
            f"cache={session.stats.as_dict()}")
        out["datasets"].append({"name": name, "images": vol.images, "results": results, "metrics": rows})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    ap.add_argument("--size", type=int, default=96)
    args = ap.parse_args(argv)
    return run(args.device, args.size)


if __name__ == "__main__":
    main()
