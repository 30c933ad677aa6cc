#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch_kernels``), holds each kernel against its plain
PyTorch version on the card, drives the segmentation path through the
session API on 512x512 synthetic slices (K = 2, then K = 3), checks that
the path went through the kernels, and prints its findings as one JSON
object per line.  The line before the last lists every kernel with its
launches on the main path, its largest error against its plain version
and its times; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises, and the script exits non-zero without that line.
It also exits non-zero when CUDA is absent or the package is not beside
it.  ``--profile`` adds device-time breakdowns from ``torch.profiler``
(each kernel alone, and one K = 2 solve with its device idle share).

Tolerances (kernel against plain version, same inputs, on the card):

* segment_reduce: integer-valued ``add`` and every ``min`` exact; random
  float ``add`` within 1e-5 of the segment's sum of magnitudes (both sum
  with atomics, in an order that changes from run to run).
* fused_em_tick at f32: labels, votes and the convergence flag exact;
  hood energies and M-step sums within rtol 1e-5 (atol 1e-4): the kernel
  sums them in another order.  At bf16: at least 95 % label agreement and
  sums within 2 %.
* The slice: kernel path against plain path at least 99.5 % pixel
  agreement, and kernel-path accuracy no more than 0.01 below.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores

SLICE = dict(size=512, grid=32, seed=0)
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float) -> tuple:
    """Least time (ms) for the work: bytes over HBM rate vs float32 ops
    over the non-tensor-core rate; returns (ms, "bytes" | "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and sum the device time of every
    kernel, memset and copy it launched: total busy microseconds and the
    largest contributors by name.  Only device-side events count (a host
    op's own entry repeats the time of the kernels it launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(e.self_device_time_total)
        if us > 0.0:
            by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + us, e.count)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "device_busy_us": sum(us for us, _ in by_name.values()),
        "top": [{"name": k[:80], "us": us, "count": n} for k, (us, n) in top],
    }


def check_segment_reduce(torch, ops, dev) -> float:
    """Kernel against plain version: 7, 24,784 (about a 512x512 slice's hood elements)
    and 10**6 elements into 1, 1555 and 10**5 segments, with padding ids."""
    import numpy as np

    rng = np.random.default_rng(0)
    worst = 0.0
    for n in (7, 24_784, 1_000_000):
        for segs in (1, 1555, 100_000):
            ids = rng.integers(-2, segs + segs // 10 + 2, n).astype(np.int32)
            ids[::13] = 2**30  # padding ids
            ids_t = torch.from_numpy(ids).to(dev)
            for kind, vals in (
                ("int", rng.integers(0, 3, n).astype(np.float32)),
                ("float", rng.normal(0.0, 1.0, n).astype(np.float32)),
            ):
                v = torch.from_numpy(vals).to(dev)
                for op in ("add", "min"):
                    k = ops.segment_reduce(v, ids_t, segs, op)
                    p = ops.segment_reduce(v, ids_t, segs, op, backend="torch")
                    torch.cuda.synchronize()
                    err = (k - p).abs().nan_to_num(0.0).max().item()
                    exact = kind == "int" or op == "min"
                    if exact:
                        if not torch.equal(k, p):
                            fail(f"segment_reduce {op} {kind} n={n} segs={segs}: not exact (err {err})")
                    else:
                        mag = ops.segment_reduce(v.abs(), ids_t, segs, "add", backend="torch")
                        if not bool(((k - p).abs() <= 1e-5 * mag + 1e-6).all()):
                            fail(f"segment_reduce add float n={n} segs={segs}: err {err}")
                    worst = max(worst, err)
    emit({"phase": "segment_reduce_check", "ok": True, "max_abs_err": worst})
    return worst


def compare_tick(torch, k, p, precision: str, what: str) -> float:
    """Hold a kernel tick ``k`` against the plain tick ``p``; returns the
    largest absolute error over the float outputs."""
    labels_k, hood_k, votes_k, conv_k = k[:4]
    labels_p, hood_p, votes_p, conv_p = p[:4]
    floats = [(hood_k, hood_p)] + list(zip(k[4:], p[4:]))
    err = max((a - b).abs().max().item() if a.numel() else 0.0 for a, b in floats)
    if precision == "f32":
        if not torch.equal(labels_k, labels_p):
            fail(f"{what}: labels differ")
        if not torch.equal(votes_k, votes_p):
            fail(f"{what}: votes differ")
        if bool(conv_k) != bool(conv_p):
            fail(f"{what}: conv differs")
        for a, b in floats:
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
                fail(f"{what}: sums differ beyond rtol 1e-5 (err {err})")
    else:
        agree = (labels_k == labels_p).float().mean().item()
        if agree < 0.95:
            fail(f"{what}: label agreement {agree}")
        for a, b in floats:
            if not torch.allclose(a, b, rtol=0.02, atol=1e-3):
                fail(f"{what}: bf16 sums drift beyond 2% (err {err})")
    return err


def check_tick_synthetic(torch, ops, dev) -> None:
    from repro_torch.testing.tick_problems import sorted_tick_problem

    for n_labels in (2, 3, 5):
        arrays, offsets = sorted_tick_problem(n_labels, n_labels, 1554, 1025, 24_784)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        off = torch.from_numpy(offsets).to(dev)
        for precision in ("f32", "bf16"):
            kw = dict(n_hoods=1554, n_vertices=1025, precision=precision)
            k = ops.fused_em_tick(*args, 0.75, offsets=off, **kw)
            p = ops.fused_em_tick(*args, 0.75, backend="torch", **kw)
            torch.cuda.synchronize()
            err = compare_tick(torch, k, p, precision, f"fused_em_tick K={n_labels} {precision}")
            emit({"phase": "fused_em_tick_check", "operands": "synthetic", "K": n_labels,
                  "precision": precision, "ok": True, "max_abs_err": err})


def real_tick_operands(torch, plan, E, em_mod):
    """The fused tick's operands at MAP iteration WINDOW+2 of the plan's
    solve (quantile init), so that the history ring holds real energies."""
    prob = plan.problem
    hoods, model = prob.hoods, prob.model
    sctx = E.make_static_context(hoods, model, backend="torch")
    labels, mu, sigma = em_mod.quantile_init(prob.graph.region_mean, prob.graph.n_regions, model.n_labels)
    hist = torch.zeros((em_mod.WINDOW + 1, hoods.n_hoods), device=labels.device)
    for _ in range(em_mod.WINDOW + 1):
        labels, hood_e, *_ = E.em_tick_fused(hoods, model, sctx, labels, mu, sigma, hist, backend="torch")
        hist = torch.cat([hood_e[None], hist[:-1]])
    x = labels[hoods.vertex.long()]
    args = (sctx.y, sctx.w, sctx.nall_e, x.float() * sctx.validf, sctx.validf, hoods.hood_id,
            hoods.vertex, model.region_mean, model.region_weight, hist, mu,
            torch.maximum(sigma, model.sigma_min), model.beta)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1)
    return args, kw


def run_slice(torch, api, metrics, synthetic, ops, dev, n_labels: int) -> dict:
    """The main path: a 512x512 slice planned and solved through the
    session API, with the launch counts reset just before and read just
    after; then the same plan solved on the plain path for comparison."""
    size, grid, seed = SLICE["size"], SLICE["grid"], SLICE["seed"]
    if n_labels == 2:
        vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size), device=dev)
    else:
        vol = synthetic.make_kary_volume(seed=seed, n_slices=1, shape=(size, size), n_phases=n_labels, device=dev)
    config = api.ExecutionConfig(
        mode="static-pallas", n_labels=n_labels, overseg_grid=(grid, grid), init="quantile"
    )
    seg = api.Segmenter(config, device=dev)

    ops.reset_launch_counts()
    plan = seg.plan(vol.images[0])
    res = seg.execute(plan, seed=seed)
    launches = ops.launch_counts()

    hoods = plan.problem.hoods
    sizes = {"n_regions": hoods.n_regions, "n_hoods": hoods.n_hoods,
             "n_elements": hoods.n_elements, "capacity": hoods.capacity}
    emit({"phase": "problem_sizes", "K": n_labels, **sizes})

    gt = vol.ground_truth[0]

    def accuracy(r):
        if n_labels == 2:
            return metrics.evaluate(r.segmentation, gt).accuracy
        return metrics.multiclass_accuracy(r.segmentation, gt, n_labels)

    plain = api.Segmenter(config.with_(backend="torch"), device=dev)
    before = ops.launch_counts()
    res_p = plain.execute(plan, seed=seed)
    if ops.launch_counts() != before:
        fail("the plain path (backend='torch') launched a kernel")

    acc, acc_p = accuracy(res), accuracy(res_p)
    agree = float((res.segmentation == res_p.segmentation).mean())
    out = {
        "phase": "slice", "K": n_labels, "size": size, "grid": grid,
        "plan_s": plan.init_seconds, "optimize_s": res.optimize_seconds,
        "em_iters": res.em_iters, "map_iters": res.map_iters, "status": res.status,
        "accuracy": acc, "launches": launches,
        "plain_optimize_s": res_p.optimize_seconds, "plain_em_iters": res_p.em_iters,
        "plain_map_iters": res_p.map_iters, "plain_status": res_p.status,
        "plain_accuracy": acc_p, "pixel_agreement": agree,
    }
    emit(out)
    if launches["fused_em_tick"] != res.map_iters:
        fail(f"fused_em_tick launched {launches['fused_em_tick']} times for {res.map_iters} MAP iterations")
    if launches["segment_reduce"] < 1:
        fail("segment_reduce never launched on the main path")
    if res.status not in ("converged", "max_iters"):
        fail(f"slice status {res.status}")
    if agree < 0.995:
        fail(f"kernel path and plain path agree on {agree:.4f} of the pixels")
    if acc < acc_p - 0.01:
        fail(f"kernel-path accuracy {acc} more than 0.01 below the plain path's {acc_p}")
    out["plan"] = plan
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--profile", action="store_true",
                    help="also trace device time with torch.profiler (kernels alone and one solve)")
    profile = ap.parse_args(argv).profile
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is not under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch import api
    from repro_torch.core import metrics, synthetic
    from repro_torch.core.pmrf import em as em_mod
    from repro_torch.core.pmrf import energy as E
    from repro_torch.kernels import _build, ops

    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    emit({"device": {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
                     "torch": torch.__version__, "cuda": torch.version.cuda}})

    emit({"phase": "build", "build_s": _build.build_all(), "dir": str(_build.BUILD_DIR)})

    sr_err = check_segment_reduce(torch, ops, dev)
    check_tick_synthetic(torch, ops, dev)

    slice2 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=2)
    plan = slice2.pop("plan")

    # The tick at the slice's real operands: check and time.
    args, kw = real_tick_operands(torch, plan, E, em_mod)
    hoods = plan.problem.hoods
    tick_err = 0.0
    for precision in ("f32", "bf16"):
        k = ops.fused_em_tick(*args, offsets=hoods.offsets, precision=precision, **kw)
        p = ops.fused_em_tick(*args, precision=precision, backend="torch", **kw)
        torch.cuda.synchronize()
        err = compare_tick(torch, k, p, precision, f"fused_em_tick slice {precision}")
        if precision == "f32":
            tick_err = err
        emit({"phase": "fused_em_tick_check", "operands": "512x512 slice", "K": 2,
              "precision": precision, "ok": True, "max_abs_err": err, "conv": bool(p[3])})
    tick_ms = time_ms(lambda: ops.fused_em_tick(*args, offsets=hoods.offsets, **kw))
    tick_plain_ms = time_ms(lambda: ops.fused_em_tick(*args, backend="torch", **kw))
    n_labels = 2
    n_run = int(hoods.offsets[-1] - hoods.offsets[0])
    nh, nv = hoods.n_hoods, hoods.n_regions + 1
    tick_bytes = (n_run * 6 * 4 + (nh + 1) * 4 + 2 * nv * 4 + (em_mod.WINDOW + 1) * nh * 4
                  + 2 * n_labels * 4 + 4                       # inputs
                  + nv * 4 + nh * 4 + n_labels * nv * 4 + 3 * n_labels * 4 + 4)  # outputs
    tick_ops = n_run * n_labels * 16 + nv * 6
    tick_bound, tick_by = bound(tick_bytes, tick_ops)

    # segment_reduce at the solve's call: neighbourhood sizes.
    validf = hoods.valid.float()
    n_seg = nh + 1
    sr = lambda: ops.segment_reduce(validf, hoods.hood_id, n_seg, "add")
    sr_ms = time_ms(sr)
    sr_plain_ms = time_ms(lambda: ops.segment_reduce(validf, hoods.hood_id, n_seg, "add", backend="torch"))
    ids_long = hoods.hood_id.long()
    lib_out = torch.zeros(n_seg, device=dev)
    sr_lib_ms = time_ms(lambda: lib_out.zero_().index_add_(0, ids_long, validf))
    if not torch.equal(sr(), lib_out):
        fail("segment_reduce and index_add_ disagree on the neighbourhood sizes")
    n = hoods.capacity
    sr_bound, sr_by = bound(n * 8 + n_seg * 4, n)
    if profile:
        # Device time alone: the per-call times above include the host's share.
        emit({"phase": "profile", "what": "20 fused_em_tick calls",
              **device_profile(torch, lambda: [ops.fused_em_tick(*args, offsets=hoods.offsets, **kw) for _ in range(20)])})
        emit({"phase": "profile", "what": "20 segment_reduce calls",
              **device_profile(torch, lambda: [sr() for _ in range(20)])})
        solve = api.Segmenter(
            api.ExecutionConfig(n_labels=2, overseg_grid=(SLICE["grid"],) * 2, init="quantile"), device=dev
        )
        wall = min(solve.execute(plan, seed=SLICE["seed"]).optimize_seconds for _ in range(3))
        prof = device_profile(torch, lambda: solve.execute(plan, seed=SLICE["seed"]))
        emit({"phase": "profile", "what": "K=2 slice solve (execute)", "optimize_s_unprofiled": wall,
              "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / wall, **prof})
    emit({"phase": "timing", "fused_em_tick_ms": tick_ms, "fused_em_tick_plain_ms": tick_plain_ms,
          "segment_reduce_ms": sr_ms, "segment_reduce_plain_ms": sr_plain_ms,
          "segment_reduce_index_add_ms": sr_lib_ms, "tick_bytes": tick_bytes,
          "segment_reduce_shape": [n, n_seg]})

    run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=3)

    launches = slice2["launches"]
    emit({"kernels": [
        {"name": "fused_em_tick", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/em_tick.cu",
         "replaces": "src/repro/kernels/em_tick.py:253",
         "launches": launches["fused_em_tick"], "max_abs_err": tick_err,
         "ms": tick_ms, "plain_ms": tick_plain_ms, "bound_ms": tick_bound,
         "bound_by": tick_by, "library_ms": None},
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce.py:71",
         "launches": launches["segment_reduce"], "max_abs_err": sr_err,
         "ms": sr_ms, "plain_ms": sr_plain_ms, "bound_ms": sr_bound,
         "bound_by": sr_by, "library_ms": sr_lib_ms},
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
