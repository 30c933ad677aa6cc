"""Quickstart on the PyTorch/CUDA port: DPP-PMRF image segmentation.

The counterpart of ``quickstart.py`` on ``repro_torch``: corrupt a known
binary porous structure, segment it with the DPP-reformulated Parallel-MRF
optimizer through the session API, and compare with ground truth and the
simple-threshold baseline (paper Fig. 1).  The solve runs the port's
default mode, ``static-pallas``: one fused EM/MAP tick kernel launch per
MAP iteration and ``segment_reduce`` for the neighbourhood sums, on the
card.  The image is made on the host from the seed, so the card and the
CPU see the same pixels.

Run:  PYTHONPATH=src python examples/torch_quickstart.py              # on the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu # plain PyTorch on the host
"""

import argparse

from repro_torch import api, resolve_device
from repro_torch.core import metrics, synthetic


def run(device=None, size: int = 96, seed: int = 0) -> dict:
    """Plan, compile and execute one ``size`` x ``size`` slice on ``device``
    (None: the card, which must be there)."""
    dev = resolve_device(device)
    # 1. A corrupted porous-media slice with known ground truth.
    vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size), device="cpu")
    image, truth = vol.images[0], vol.ground_truth[0]

    # 2. The paper's pipeline through the session API: plan (oversegment ->
    #    graph -> cliques -> neighbourhoods), compile (the bucket's
    #    workspace, cached), execute (EM/MAP on the kernels).
    config = api.ExecutionConfig(overseg_grid=(12, 12), init="quantile")
    seg = api.Segmenter(config, device=dev)
    plan = seg.plan(image.to(dev))
    seg.compile(plan)        # explicit; execute() would compile on a miss
    result = seg.execute(plan, seed=seed)

    # 3. Compare with ground truth and the threshold baseline (Fig. 1d).
    return {"config": config, "session": seg, "plan": plan, "result": result, "seed": seed,
            "ours": metrics.evaluate(result.segmentation, truth),
            "threshold": metrics.evaluate(synthetic.threshold_baseline(image), truth)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    ap.add_argument("--size", type=int, default=96)
    args = ap.parse_args(argv)

    out = run(args.device, args.size)
    result, ours, thresh = out["result"], out["ours"], out["threshold"]
    print(f"EM iterations        : {result.em_iters} (MAP total {result.map_iters})")
    print(f"optimize wall time   : {result.optimize_seconds:.3f}s "
          f"(init {result.init_seconds:.3f}s)")
    print(f"DPP-PMRF  accuracy={ours.accuracy:.3f} precision={ours.precision:.3f} "
          f"recall={ours.recall:.3f}")
    print(f"threshold accuracy={thresh.accuracy:.3f} precision={thresh.precision:.3f} "
          f"recall={thresh.recall:.3f}")
    assert ours.accuracy > thresh.accuracy - 0.05, "MRF should beat/match threshold"
    return out


if __name__ == "__main__":
    main()
