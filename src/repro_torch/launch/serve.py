"""Segmentation serving driver: a synthetic request stream through the
continuous-batching engine (counterpart of ``repro.launch.serve``).

Plans ``--requests`` slices of a synthetic volume (binary, or K phases
with ``--labels K``), fixes the pool's bucket at their joint one, compiles
the pool (every ladder size under ``--tick-iters auto``) outside the timed
window, submits every request to a ``SegmentationEngine`` and runs it.  It
prints one JSON line per completion (rid, status, iteration counts,
latency split, slot) and a summary line: throughput, latency percentiles
(queue and residence apart), and the engine's ``stats()``.

``--check`` solves every healthy request again through the session's
serial ``execute`` and exits 1 unless each completion equals it bit for
bit (labels, segmentation, mu, sigma, iteration counts, status).
``--chaos`` assigns ``--poison-rate`` of the stream a fault round-robin
(``nan_image``: refused at submit; ``bad_init``, ``nan_data``: retire
``diverged``; ``never_converge``: evicted); with ``--check`` each faulted
request must get that disposition.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 24 --shape 512 --grid 32 \\
        --max-batch 8 --tick-iters 4 --init quantile --check
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --check
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch import api, resolve_device
from repro_torch.core import synthetic
from repro_torch.serving import SegmentationEngine
from repro_torch.serving.engine import DEFAULT_TICK_LADDER
from repro_torch.testing import chaos as chaos_mod

#: Fault classes --chaos cycles through (round-robin over the poisoned rids).
CHAOS_CYCLE = ("bad_init", "nan_image", "never_converge", "nan_data")


def assign_faults(n_requests: int, rate: float, seed: int) -> dict:
    """Deterministic rid -> fault map: ``round(n * rate)`` rids (at least 1
    when rate > 0) by a seeded choice, the classes assigned round-robin."""
    if rate <= 0:
        return {}
    k = min(n_requests, max(1, round(n_requests * rate)))
    rng = np.random.default_rng(seed)
    rids = sorted(rng.choice(n_requests, size=k, replace=False).tolist())
    return {rid: CHAOS_CYCLE[i % len(CHAOS_CYCLE)] for i, rid in enumerate(rids)}


def _same(got, want) -> bool:
    return (np.array_equal(got.region_labels, want.region_labels)
            and np.array_equal(got.segmentation, want.segmentation)
            and np.array_equal(got.mu, want.mu) and np.array_equal(got.sigma, want.sigma)
            and (got.em_iters, got.map_iters, got.status) == (want.em_iters, want.map_iters,
                                                              want.status))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--shape", type=int, default=64, help="square slice edge")
    ap.add_argument("--grid", type=int, default=8, help="oversegmentation grid edge")
    ap.add_argument("--max-batch", type=int, default=8, help="engine slot count")
    ap.add_argument("--tick-iters", default="8",
                    help="micro-steps per engine tick: an int, or 'auto' (the adaptive ladder)")
    ap.add_argument("--mode", default="static-pallas", choices=("static-pallas",),
                    help="EM mode (the one ported so far)")
    ap.add_argument("--labels", type=int, default=2, metavar="K",
                    help="label count K; K > 2 serves a K-phase synthetic stream")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="hold every healthy completion to serial execute bit for bit; exit 1 if not")
    ap.add_argument("--chaos", action="store_true", help="inject deterministic request faults")
    ap.add_argument("--poison-rate", type=float, default=0.25,
                    help="fraction of requests assigned a fault under --chaos")
    ap.add_argument("--init", default="quantile", choices=("random", "quantile"))
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if not 0.0 <= args.poison_rate <= 1.0:
        ap.error("--poison-rate must be in [0, 1]")
    if args.tick_iters == "auto":
        tick_iters = "auto"
    else:
        try:
            tick_iters = int(args.tick_iters)
        except ValueError:
            ap.error(f"--tick-iters must be an int or 'auto', got {args.tick_iters!r}")
    device = resolve_device(args.device)

    cfg = api.ExecutionConfig(
        mode=args.mode, overseg_grid=(args.grid, args.grid),
        capacity_bucket=4096, n_labels=args.labels, init=args.init,
    )
    sess = api.Segmenter(cfg, device=device)
    shape = (args.shape, args.shape)
    if args.labels > 2:
        vol = synthetic.make_kary_volume(seed=args.seed, n_slices=args.requests, shape=shape,
                                         n_phases=args.labels, device=device)
    else:
        vol = synthetic.make_synthetic_volume(seed=args.seed, n_slices=args.requests, shape=shape,
                                              device=device)
    imgs = list(vol.images)

    faults = assign_faults(args.requests, args.poison_rate, args.seed) if args.chaos else {}
    chaos_cfg = chaos_mod.ChaosConfig(
        seed=args.seed,
        **{f"{name}_rids": tuple(r for r, f in faults.items() if f == name)
           for name in chaos_mod.REQUEST_FAULTS},
    )
    # Plans are made up front (plan time is not serving time); nan_image
    # rids get a poisoned image instead, which submit must refuse.
    plans = {rid: sess.plan(img) for rid, img in enumerate(imgs) if faults.get(rid) != "nan_image"}

    # The pool's bucket and every tick size it may run, outside the timed window.
    bucket = None
    if plans:
        bucket = api.BucketKey(*(max(p.bucket[d] for p in plans.values()) for d in range(3)))
        for t in DEFAULT_TICK_LADDER if tick_iters == "auto" else (tick_iters,):
            sess.compile_ticked(bucket, batch=args.max_batch, tick_iters=t)
    engine = SegmentationEngine(sess, max_batch=args.max_batch, tick_iters=tick_iters, bucket=bucket)
    rejected = []
    with chaos_mod.inject(chaos_cfg) as monkey:
        t0 = time.perf_counter()
        for rid in range(args.requests):
            if faults.get(rid) == "nan_image":
                try:
                    engine.submit(monkey.poison_image(imgs[rid], rid), rid=rid, seed=args.seed)
                except api.ServingError:
                    rejected.append(rid)
                continue
            engine.submit(plans[rid], rid=rid, seed=args.seed)
        completions = engine.run()
        wall = time.perf_counter() - t0

    for c in completions:
        print(json.dumps({"rid": c.rid, "status": c.status, "em_iters": c.result.em_iters,
                          "map_iters": c.result.map_iters, "latency_s": c.latency_s,
                          "queue_s": c.queue_s, "residence_s": c.residence_s,
                          "ticks_resident": c.ticks_resident, "slot": c.slot}))
    by_rid = {c.rid: c for c in completions}
    healthy = [c for c in completions if c.rid not in faults]
    pct = lambda xs, q: float(np.percentile(xs, q)) if len(xs) else None  # noqa: E731
    lat = [c.latency_s for c in completions]
    report = {
        "requests": len(completions), "labels": args.labels, "max_batch": args.max_batch,
        "tick_policy": "auto" if tick_iters == "auto" else "fixed", "device": str(device),
        "bucket": list(engine.bucket) if engine.bucket else None, "wall_s": wall,
        "throughput_rps": len(completions) / wall, "healthy_rps": len(healthy) / wall,
        "latency_p50_s": pct(lat, 50), "latency_p99_s": pct(lat, 99),
        "queue_p50_s": pct([c.queue_s for c in completions], 50),
        "residence_p50_s": pct([c.residence_s for c in completions], 50),
        "residence_p99_s": pct([c.residence_s for c in completions], 99),
        **engine.stats(),
    }
    if args.chaos:
        report["chaos"] = {
            "seed": args.seed, "poison_rate": args.poison_rate,
            "faults": {str(r): f for r, f in sorted(faults.items())}, "rejected_rids": rejected,
            "statuses": {str(c.rid): c.status for c in completions if not c.ok},
            "injections": len(monkey.events),
        }

    failures = []
    if args.check:
        # Healthy lanes against serial execute, outside the chaos context.
        for c in sorted(healthy, key=lambda c: c.rid):
            if not _same(c.result, sess.execute(plans[c.rid], seed=args.seed)):
                failures.append(f"rid {c.rid}: not bit for bit its serial execute")
        want = {"bad_init": "diverged", "nan_data": "diverged", "never_converge": "evicted"}
        for rid, fault in sorted(faults.items()):
            if fault == "nan_image":
                if rid not in rejected:
                    failures.append(f"rid {rid}: poisoned image was not rejected")
            elif rid not in by_rid:
                failures.append(f"rid {rid}: faulted request never completed")
            elif by_rid[rid].status != want[fault]:
                failures.append(f"rid {rid}: {fault} lane status {by_rid[rid].status!r}, "
                                f"want {want[fault]!r}")
        report["check"] = "ok" if not failures else failures
    print(json.dumps(report))
    if failures:
        print("serve --check FAILED:", *failures, sep="\n  ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
