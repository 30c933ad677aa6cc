#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch_kernels``), holds each kernel against its plain
PyTorch version on the card, and drives three paths:

* the single-device segmentation path on 512x512 synthetic slices (K = 2,
  then K = 3, then K = 9 labels on the three-phase image, which runs the
  tick's runtime-K variant), planned and solved through the session API
  (one ``fused_em_tick`` launch and one flag read per MAP iteration, on
  the plan's ``TickWorkspace``);
* the sharded route: ``run_em_sharded`` on the same plans over a
  one-rank NCCL process group made in this process, on the rank's
  ``MapStepWorkspace`` (per MAP iteration one ``fused_map_step`` launch,
  one all-reduce of its hood sums and votes, one flag read and, past the
  window, the AND of the flag word);
* LM serving: ``qwen2-1.5b`` at full width and depth (28 layers, bf16,
  random weights from a ``torch.Generator`` seeded 0) behind
  ``ServingEngine(max_batch=4, max_seq=2048)``, greedy, 8 requests (4
  prompts of 512 tokens, 4 of 1024, from ``numpy.random.default_rng(0)``)
  of 32 new tokens each: one ``flash_attention`` launch per layer and
  prefilled request, 224 in all, every one on the bf16 tensor-core
  kernel (``flash_attention.launches_tc``).

For each path it sets the launch counts to 0 just before and reads them
just after, checks that the path went through its kernels, and holds it
against its own plain path (``backend="torch"``, which must launch no
kernel) and, for the sharded route, against the single-device route.  It
prints its findings as one JSON object per line.  The last three lines
are: the ``kernels`` line, which lists every kernel with its launches on
its path, its largest error against its plain version, its times and its
bound; then the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them; then
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that last line.  It also exits non-zero
when CUDA is absent or the package is not beside it.  ``--profile`` adds
device-time breakdowns from ``torch.profiler`` (each kernel alone, one
K = 2 solve of each segmentation path after 10 timed warm solves, and one
LM prefill at S = 1024 and one decode step, with their device idle
shares).  Float32 products run in
full float32 (TF32 off, the defaults, set explicitly).  After the build
a ``ptxas`` line gives the registers and spills of the tensor-core flash
kernels (any spill in the flash library fails the run); the
``flash_attention`` timing lines give both model shapes with their device
times (``torch.profiler``), ``scaled_dot_product_attention`` beside them
and the share of the bound; the ``kernels`` line adds the count of
``HGMMA`` instructions in the flash library's SASS where ``cuobjdump``
exists.

Tolerances (kernel against plain version, same inputs, on the card):

* segment_reduce: integer-valued ``add`` and every ``min`` exact; random
  float ``add`` within 1e-5 of the segment's sum of magnitudes (+ 1e-6):
  the plain version sums with atomics in an order that changes from run to
  run, the kernel on a fixed-point grid.  Float ``add`` is order-free: at
  24,784 and 10**6 shuffled values into 1555 and 10**5 segments, and at
  the solve's and the plan's real calls, 20 calls and a permutation of the
  elements give the first call's bits, and the kernel equals the numpy
  model of its arithmetic (``repro_torch.testing.segsum``) bit for bit.
  With NaN and infinities (NaN in ``add`` and ``min``, +inf with -inf in
  ``add``) it equals the plain version exactly, NaN equal to NaN.
* fused_em_tick at f32: labels, votes and the convergence flag exact;
  hood energies and M-step sums within rtol 1e-5 (atol 1e-4): the kernel
  sums them in another order.  At bf16: at least 95 % label agreement and
  sums within 2 %.  K = 2, 3, 5 and the runtime-K variant at 9, 16, 33 on
  synthetic operands; K = 2 and 9 at the slices' operands.  The runtime-K
  variant (K >= 9) sums in element order, so at f32 it also equals the
  plain tick on the CPU (where ``index_add_`` adds in element order) bit
  for bit in every output.
* The MAP step (``TickWorkspace.step``, the main path's entry of the
  tick) at the K = 2, 3 and 9 slices' real state (MAP iteration WINDOW+2,
  computed on the CPU): against the plain MAP iteration on the card in the
  tiers above, flag words equal at f32; bit for bit equal to the
  JAX-signature entry of the same kernel; at K = 9 bit for bit equal to the
  plain MAP iteration on the CPU.  Repeat check: 20 steps from one state
  (labels, ring, head restored) give the same bits.  Profiler check: 20
  steps with their flag reads issue exactly 20 kernels, all the tick, no
  memset and at most 20 device-to-host copies (the flag goes to mapped
  pinned memory, so none).  Printed: ms per MAP step (step and flag), ms
  per back-to-back step, device us per step, the bound, the device
  operations of one warm K = 2 solve, and the tick's ``ptxas`` registers
  and spills.
* The plan: a second ``Segmenter.plan`` of the K = 2 slice's image on the
  card equals the first bit for bit (the label map and every ``Hoods``
  array); whether it equals the plan the plain path makes on the CPU is
  printed, not held.
* The sharded MAP step (``MapStepWorkspace.step``, the route's entry of
  ``fused_map_step``), step by step over whole sharded solves of the
  K = 2, 3 and 9 slices: from the same state as the kernel, the plain
  workspace on the card gives the same labels, flag words and ring bit for
  bit, the same votes and hood sums within rtol 1e-5 (atol 1e-4); the
  JAX-signature entry on the counts of the same labels gives the step's
  hood sums and votes bit for bit.  Profiler check: 20 MAP iterations as
  the driver runs them (step, flag AND, flag read, all-reduce) issue 20
  map-step kernels and no memset, no copy and no other kernel than
  NCCL's (counted apart).  Printed: ms per MAP iteration, ms per step
  back to back, device us per step, the plain step's ms, the bound.
* fused_map_step's JAX-signature entry (at the slices' quantile-init
  operands, and on hoods of 100 and 300 elements): min_e, arg and votes
  exact; hood energies within
  rtol 1e-5 (atol 1e-4): the kernel rounds a fixed-point sum once, the
  plain version sums in element order.  On the long hoods 20 calls give
  the first call's hood sums bit for bit, the numpy model's.  The votes
  of the four element blocks of ``partition_hoods(hoods, 4)`` add up to
  the whole problem's exactly.
* mrf_min_energy (at the K = 2 slice's operands, n1 = label-1 counts):
  min_e and arg exact.
* flash_attention: the reference tests' shapes (B, Hq, Hkv, S, D) =
  (1,2,2,128,32), (2,4,2,256,64), (1,8,1,128,16), (1,2,1,512,64) and a
  ragged (1,4,2,200,32), causal and not, within 2e-4 (rtol and atol) at
  f32 and 2e-2 at bf16, the tiers of ``tests/test_kernels.py``; the
  model's (1,12,2,S,128) at S = 512 and 1024, bf16, causal, within 2e-2;
  and, for the tensor-core kernel off the model's shapes, (2,4,2,200,128)
  and (1,2,1,33,64) in bf16, causal and not, within 2e-2.  The CUDA-core
  kernel (float32, and bf16 at D other than 64 and 128) computes in
  float32 and differs in the order of the sums; the tensor-core kernel
  (bf16 at D = 64, 128) also rounds the probabilities to bf16 before the
  value product, as the JAX reference does.  Each case names the kernel
  the C entry point reported it ran.  Those inputs give an almost flat
  softmax, so the tensor-core kernel is also held on peaked scores
  (``repro_torch.testing.flash_cases.PEAKED_CASES``: the model's shapes
  with q scaled by 10, 30 and 1000, and (2,4,2,256,64) by 30, causal and
  not): each output row within ``ROW_TOL`` = 4 * 2^-8 of the row's
  largest |value|.  A kernel that does not rescale its accumulator when
  the running max grows, or does not subtract the max, fails it.
* The slice: kernel path against plain path at least 99.5 % pixel
  agreement, and kernel-path accuracy no more than 0.01 below; at every K
  also the status and EM and MAP iteration counts of the plain path on
  the CPU, which sums in element order as the runtime-K tick does (on the
  card the plain path's ``index_add_`` adds by atomics, and its counts
  moved by one MAP iteration between runs at K = 9).  The
  sharded route is held to the same limits against the single-device
  route and against its own plain path; its ``sharded_slice`` line counts
  its collectives (all-reduces per solve: one per MAP iteration, the flag
  ANDs, the EM window's ANDs and three per solve), and its
  ``fused_map_step`` launches must be its MAP plus its EM iterations and
  its ``segment_reduce`` launches one plus three per EM iteration (the
  label counts no longer go through it).
* LM serving: every request completes with 32 tokens in the vocabulary.
  Kernel path against plain path on the same weights: (a) a 2-layer f32
  variant at full width (d_model 1536, vocab 151,936) gives identical
  greedy tokens for every request and last-position prefill logits
  within rtol 1e-4 (atol 1e-5); (b) the 28-layer bf16 model gives the
  same first token on at least 7 of 8 requests and prefill logits with
  cosine similarity at least 0.99 (bf16 rounds the attention output
  differently in the two paths, and 28 layers carry it on).  Beside (b)
  each request's top-1 minus top-2 logit on the plain path is printed, so
  that a differing first token reads as a near-tie or as an error.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate

SLICE = dict(size=512, grid=32, seed=0)
# The LM serving path: qwen2-1.5b at full width and depth, random weights.
LM = dict(arch="qwen2-1.5b", max_batch=4, max_seq=2048, lengths=(512, 1024), per_length=4,
          max_new=32, seed=0)
# flash_attention checks: (B, Hq, Hkv, S, D).  The reference tests' shapes
# and a ragged S, f32 and bf16, causal and not; the model's shape, bf16 causal.
FLASH_REF_SHAPES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 16),
                    (1, 2, 1, 512, 64), (1, 4, 2, 200, 32)]
FLASH_MODEL_SHAPES = [(1, 12, 2, 512, 128), (1, 12, 2, 1024, 128)]
# Shapes that reach the bf16 tensor-core kernel off the model's path: a
# ragged S with B = 2 at D = 128, and S shorter than one 64-row tile at D = 64.
FLASH_TC_SHAPES = [(2, 4, 2, 200, 128), (1, 2, 1, 33, 64)]
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DEVICE = "cuda"
REPEATS = 20  # calls of an order-free kernel that must agree bit for bit
SOLVES = 10   # warm solves timed under --profile (min, median, max)
TICK_LABELS = (2, 3, 5, 9, 16, 33)  # synthetic tick checks; K >= 9 is the runtime-K variant
MAP_STEPS = 20  # MAP steps of the repeat and profiler checks
PROFILE_ATTEMPTS = 3  # profiles of MAP_STEPS steps, for the records the profiler drops
PROFILER_SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's clock, before each traced window


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


def spread(values: list) -> dict:
    """Min, median and max of repeated measurements."""
    v = sorted(values)
    return {"n": len(v), "min": v[0], "median": v[len(v) // 2], "max": v[-1]}


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    """Least time (ms) for the work: bytes over HBM rate vs ops over the
    card's peak for their type (default float32 outside the tensor cores);
    returns (ms, "bytes" | "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and sum the device time of every
    kernel, memset and copy it launched: total busy microseconds and the
    largest contributors by name, and every kernel of the order-free keyed
    reductions (``segsum::``: ``segment_reduce``'s passes and
    ``fused_map_step``'s hood sums).  Only device-side events count (a host
    op's own entry repeats the time of the kernels it launched).
    ``host_top`` lists the host ops with the most self time on the CPU,
    where a host-bound solve spends its time (the profiler's own cost
    included).  ``device_ops`` counts the device operations, split into
    ``kernels``, ``memsets`` and ``memcpys``.

    The tracing drops the device records of a trace's first milliseconds
    on the H100 (it lost 1 of 20 ticks in one run and all 20 flash
    launches in another, while its record buffer was requested), so each
    trace first spins the card for about 10 ms (``torch.cuda._sleep``,
    kernel ``spin_kernel``), which is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILER_SPIN_CYCLES)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    by_name, host = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            host.append((float(e.self_cpu_time_total), e.key, e.count))
            continue
        if "spin_kernel" in e.key:
            continue
        us = float(e.self_device_time_total)
        if us > 0.0:
            by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + us, e.count)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    kinds = {"kernels": 0, "memsets": 0, "memcpys": 0}
    for k, (_, n) in by_name.items():
        kinds["memsets" if k.startswith("Memset") else "memcpys" if k.startswith("Memcpy") else "kernels"] += n
    return {
        "device_busy_us": sum(us for us, _ in by_name.values()),
        "device_ops": sum(kinds.values()), **kinds,
        "top": [{"name": k[:80], "us": us, "count": n} for k, (us, n) in top],
        "segsum": [{"name": k[:80], "us": us, "count": n} for k, (us, n) in by_name.items()
                   if k.startswith(("segsum::", "void segsum::"))],
        "host_top": [{"name": k[:60], "self_us": us, "count": n}
                     for us, k, n in sorted(host, reverse=True)[:10]],
        "allreduces": sum(n for _, k, n in host if k == "c10d::allreduce_"),
    }


def profile_solve(torch, what: str, solve) -> dict:
    """``optimize_s`` of ``SOLVES`` warm calls of ``solve`` (min, median,
    max), then one more under ``device_profile``: its device operations,
    all-reduces and the device's idle share against the best unprofiled
    solve."""
    walls = spread([solve().optimize_seconds for _ in range(SOLVES)])
    prof = device_profile(torch, solve)
    out = {"phase": "profile", "what": what, "optimize_s_unprofiled": walls["min"],
           "optimize_s_spread": walls,
           "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / walls["min"], **prof}
    emit(out)
    return out


def check_segment_reduce(torch, ops, dev) -> float:
    """Kernel against plain version: 7, 24,784 (about a 512x512 slice's hood elements)
    and 10**6 elements into 1, 1555 and 10**5 segments, with padding ids."""
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


def random_add_cases() -> list:
    """Float ``add`` cases for the order-free checks: 24,784 and 10**6
    normal values into 1555 and 10**5 segments, ids shuffled, with the
    padding ids of ``check_segment_reduce``."""
    rng = np.random.default_rng(1)
    cases = []
    for n in (24_784, 1_000_000):
        for segs in (1555, 100_000):
            ids = rng.integers(-2, segs + segs // 10 + 2, n).astype(np.int32)
            ids[::13] = 2**30
            cases.append((f"random n={n} segs={segs}", rng.normal(0.0, 1.0, n).astype(np.float32),
                          ids, segs))
    return cases


def bits(t) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def check_segment_reduce_order_free(torch, ops, dev, cases) -> list:
    """Float ``add`` on each ``(what, values, ids, segments)`` case: 20
    calls bitwise equal to the first, a permutation of the elements too;
    equal bit for bit to the numpy model of the kernel's arithmetic
    (``repro_torch.testing.segsum``); within 1e-5 of each segment's sum of
    magnitudes (+ 1e-6) of the plain version.  Returns one row per case."""
    from repro_torch.testing import segsum

    rows = []
    for what, vals, ids, segs in cases:
        v, i = torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev)
        first = bits(ops.segment_reduce(v, i, segs, "add"))
        repeats_equal = all(np.array_equal(bits(ops.segment_reduce(v, i, segs, "add")), first)
                            for _ in range(REPEATS - 1))
        perm = torch.randperm(len(vals), generator=torch.Generator().manual_seed(0)).to(dev)
        permuted_equal = np.array_equal(bits(ops.segment_reduce(v[perm], i[perm], segs, "add")), first)
        model_equal = np.array_equal(segsum.segment_sum(vals, ids, segs).view(np.uint32), first)
        p = ops.segment_reduce(v, i, segs, "add", backend="torch")
        mag = ops.segment_reduce(v.abs(), i, segs, "add", backend="torch")
        k = torch.from_numpy(first.view(np.float32)).to(dev)
        err = (k - p).abs().max().item() if segs else 0.0
        row = {"case": what, "n": len(vals), "segments": segs, "repeats": REPEATS,
               "repeats_bitwise_equal": repeats_equal, "permuted_bitwise_equal": permuted_equal,
               "model_bitwise_equal": model_equal, "max_abs_err_vs_plain": err}
        rows.append(row)
        if not (repeats_equal and permuted_equal and model_equal):
            fail(f"segment_reduce add {what}: not order-free or not the model's result: {row}")
        if not bool(((k - p).abs() <= 1e-5 * mag + 1e-6).all()):
            fail(f"segment_reduce add {what}: err {err} against the plain version")
    emit({"phase": "segment_reduce_order_free_check", "ok": True, "cases": rows})
    return rows


def check_segment_reduce_nonfinite(torch, ops, dev) -> None:
    """NaN in ``add`` and ``min``, +inf with -inf in ``add``: the kernel
    equals the plain version exactly on every non-finite result and every
    minimum (NaN equal to NaN; finite sums within the float tier) and the
    numpy model bit for bit.  A small hand-made case and 24,784 values with
    NaN and infinities scattered over 1555 segments."""
    from repro_torch.testing import segsum

    rng = np.random.default_rng(2)
    big = rng.normal(0.0, 1.0, 24_784).astype(np.float32)
    big[rng.integers(0, big.size, 40)] = np.nan
    big[rng.integers(0, big.size, 60)] = np.inf
    big[rng.integers(0, big.size, 60)] = -np.inf
    cases = [
        ("hand-made", np.array([1, np.nan, 3, -np.inf, np.inf, 2, np.inf, 5, -np.inf, np.nan, -7,
                                -np.inf], np.float32),
         np.array([0, 0, 1, 2, 2, 3, 5, 5, 6, 6, 2**30, 7], np.int32), 9),
        ("scattered", big, rng.integers(0, 1555, big.size).astype(np.int32), 1555),
    ]
    rows = []
    for what, vals, ids, segs in cases:
        v, i = torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev)
        for op, model in (("add", segsum.segment_sum), ("min", segsum.segment_min)):
            k = ops.segment_reduce(v, i, segs, op)
            p = ops.segment_reduce(v, i, segs, op, backend="torch")
            same = (k == p) | (k.isnan() & p.isnan())
            finite = k.isfinite() & p.isfinite()
            if op == "add":  # finite sums: the float tier of check_segment_reduce
                mag = ops.segment_reduce(v.abs().nan_to_num(0.0, 0.0, 0.0), i, segs, "add", backend="torch")
                same |= finite & ((k - p).abs() <= 1e-5 * mag + 1e-6)
            equal = bool(same.all())
            model_equal = np.array_equal(bits(k), model(vals, ids, segs).view(np.uint32))
            row = {"case": what, "op": op, "nan_segments": int(k.isnan().sum()),
                   "inf_segments": int(k.isinf().sum()), "equal_plain": equal,
                   "model_bitwise_equal": model_equal}
            rows.append(row)
            if not (equal and model_equal):
                fail(f"segment_reduce {op} non-finite {what}: {row}")
    emit({"phase": "segment_reduce_nonfinite_check", "ok": True, "cases": rows})


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


def same_bits(torch, a, b) -> bool:
    """Two tensors equal bit for bit (floats by their bits)."""
    as_bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return torch.equal(as_bits(a), as_bits(b))


def check_tick_synthetic(torch, ops, dev) -> None:
    from repro_torch.testing.tick_problems import sorted_tick_problem

    for n_labels in TICK_LABELS:
        arrays, offsets = sorted_tick_problem(n_labels, n_labels, 1554, 1025, 24_784)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        off = torch.from_numpy(offsets).to(dev)
        for precision in ("f32", "bf16"):
            kw = dict(n_hoods=1554, n_vertices=1025, precision=precision)
            k = ops.fused_em_tick(*args, 0.75, offsets=off, **kw)
            p = ops.fused_em_tick(*args, 0.75, backend="torch", **kw)
            torch.cuda.synchronize()
            err = compare_tick(torch, k, p, precision, f"fused_em_tick K={n_labels} {precision}")
            row = {"phase": "fused_em_tick_check", "operands": "synthetic", "K": n_labels,
                   "precision": precision, "ok": True, "max_abs_err": err}
            if n_labels >= 9:
                row.update(check_tick_against_cpu(
                    torch, ops, k, [*args, 0.75], dict(n_hoods=1554, n_vertices=1025), precision,
                    f"synthetic K={n_labels}"))
            emit(row)


TICK_OUTPUTS = ("labels", "hood_e", "votes", "conv", "sum_w", "sum_wy", "sum_wyy")


def check_tick_against_cpu(torch, ops, k, args, kw, precision: str, what: str) -> dict:
    """The runtime-K tick (K >= 9) sums in the plain version's element
    order, so at f32 it equals bit for bit the plain tick on the CPU, where
    ``index_add_`` adds in element order (on the card it adds by atomics).
    Every output must, except where the host's ``log`` of the tick's
    sigmas differs from the card's in the last bit (``log_sigma_equal_cpu``
    false): then the energies differ by an ulp and the hood sums are held
    to the tier of ``compare_tick`` alone.  Returns the flags."""
    from repro_torch.testing.tick_problems import FIELDS

    host = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    p = ops.fused_em_tick(*host, precision=precision, backend="torch", **kw)
    sigma = args[FIELDS.index("sigma")]
    same_log = torch.equal(torch.log(sigma[:, None]).cpu(), torch.log(sigma.cpu()[:, None]))
    unequal = [n for n, a, b in zip(TICK_OUTPUTS, k, p) if not same_bits(torch, a.cpu(), b)]
    out = {"bitwise_equal_plain_cpu": not unequal, "log_sigma_equal_cpu": same_log}
    if unequal:
        out["unequal"] = unequal
    allowed = set() if same_log else {"hood_e"}
    if precision == "f32" and not set(unequal) <= allowed:
        fail(f"fused_em_tick {what} f32: {unequal} not bitwise equal to the plain tick on the CPU")
    return out


def real_map_state(torch, plan, E, em_mod):
    """The single-device MAP loop's state at iteration WINDOW+2 of the
    plan's solve (quantile init), so that the history ring holds real
    energies: computed on the plain path with the problem copied to the
    CPU (element-order sums, the same bits in every run), then moved to
    the card.  ``cpu`` holds the CPU copies (problem, state)."""
    from repro_torch.core.pmrf import convert, pipeline
    from repro_torch.kernels import ref

    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, 0, "quantile")
    d = {f: getattr(prob.hoods, f) for f in convert.HOODS_ARRAYS + convert.HOODS_SIZES}
    d.update({f: getattr(prob.model, f) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    hoods, model, labels, mu, sigma = convert.problem_from_numpy(d, device="cpu")
    sctx = E.make_static_context(hoods, model, backend="torch")
    sig = torch.maximum(sigma, model.sigma_min)
    ws = ref.PlainTickWorkspace(hoods, model, conv_tol=em_mod.CONV_TOL, window=em_mod.WINDOW)
    ws.start(sctx.y, sctx.w, sctx.nall_e, sctx.validf, labels)
    ws.begin_em(mu, sig)
    for _ in range(em_mod.WINDOW + 1):
        ws.step(False)
    cpu = dict(hoods=hoods, model=model, elements=(sctx.y, sctx.w, sctx.nall_e, sctx.validf),
               labels=ws.labels, ring=ws.ring.clone(), head=ws.head, mu=mu, sig=sig)
    dev = prob.hoods.vertex.device
    on = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in cpu.items()
          if k not in ("hoods", "model")}
    on["elements"] = tuple(t.to(dev) for t in cpu["elements"])
    return {**on, "cpu": cpu}


def newest_first(ring, head: int):
    """The ring's rows newest first, as the JAX kernel's ``hist``."""
    rows = int(ring.shape[0])
    return ring[[(head + r) % rows for r in range(rows)]].contiguous()


def real_tick_operands(torch, plan, E, em_mod):
    """The fused tick's operands (the JAX kernel's signature) at the state
    of ``real_map_state``."""
    st = real_map_state(torch, plan, E, em_mod)
    hoods, model = plan.problem.hoods, plan.problem.model
    y, w, nall_e, validf = st["elements"]
    xf = st["labels"][hoods.vertex.long()].float() * validf
    args = (y, w, nall_e, xf, validf, hoods.hood_id, hoods.vertex, model.region_mean,
            model.region_weight, newest_first(st["ring"], st["head"]), st["mu"], st["sig"],
            model.beta)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1)
    return args, kw


def check_time_tick(torch, ops, E, em_mod, plan, profile: bool) -> dict:
    """The tick at a slice plan's real operands (``real_tick_operands``):
    held against its plain version at f32 and bf16, then timed (CUDA
    events; device time under ``--profile``) beside its plain version and
    its bound.  Returns the figures for the ``kernels`` line."""
    args, kw = real_tick_operands(torch, plan, E, em_mod)
    hoods = plan.problem.hoods
    n_labels = plan.problem.model.n_labels
    out = {"K": n_labels}
    for precision in ("f32", "bf16"):
        k = ops.fused_em_tick(*args, offsets=hoods.offsets, precision=precision, **kw)
        p = ops.fused_em_tick(*args, precision=precision, backend="torch", **kw)
        torch.cuda.synchronize()
        err = compare_tick(torch, k, p, precision, f"fused_em_tick slice K={n_labels} {precision}")
        if precision == "f32":
            out["max_abs_err"] = err
        row = {"phase": "fused_em_tick_check", "operands": "512x512 slice", "K": n_labels,
               "precision": precision, "ok": True, "max_abs_err": err, "conv": bool(p[3])}
        if n_labels >= 9:
            row.update(check_tick_against_cpu(torch, ops, k, args, kw, precision, f"slice K={n_labels}"))
        emit(row)
    kern = lambda: ops.fused_em_tick(*args, offsets=hoods.offsets, **kw)
    out["ms"] = time_ms(kern)
    out["plain_ms"] = time_ms(lambda: ops.fused_em_tick(*args, backend="torch", **kw))
    n_run = int(hoods.offsets[-1] - hoods.offsets[0])
    nh, nv = hoods.n_hoods, hoods.n_regions + 1
    n_bytes = (n_run * 6 * 4 + (nh + 1) * 4 + 2 * nv * 4 + (em_mod.WINDOW + 1) * nh * 4
               + 2 * n_labels * 4 + 4                       # inputs
               + nv * 4 + nh * 4 + n_labels * nv * 4 + 3 * n_labels * 4 + 4)  # outputs
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_run * n_labels * 16 + nv * 6)
    out["bytes"] = n_bytes
    if profile:
        prof = device_profile(torch, lambda: [kern() for _ in range(20)])
        emit({"phase": "profile", "what": f"20 fused_em_tick calls (K={n_labels})", **prof})
        out["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
    emit({"phase": "timing", "what": f"fused_em_tick K={n_labels}", **out})
    return out


def map_step_workspace(ops, em_mod, hoods, model, st, precision="f32", backend=None):
    """A MAP-iteration workspace (the kernel's on the card, the plain one
    with ``backend="torch"`` or on the CPU) holding the state ``st`` of
    ``real_map_state`` (or its ``cpu`` part)."""
    ws = ops.tick_workspace(hoods, model, precision=precision, conv_tol=em_mod.CONV_TOL,
                            window=em_mod.WINDOW, backend=backend)
    ws.start(*st["elements"], st["labels"])
    ws.begin_em(st["mu"], st["sig"])
    load_state(ws, st)
    return ws


def load_state(ws, st) -> None:
    """Put the labels, the ring and its head of ``st`` back into ``ws``."""
    ws.labels.copy_(st["labels"])
    ws.ring.copy_(st["ring"])
    ws.head = st["head"]


def map_step(ws) -> tuple:
    """One gated MAP step and its flag: ``(labels, hood_e, votes, flag,
    sum_w, sum_wy, sum_wyy)``, copied out of the workspace."""
    ws.step(True)
    flag = ws.flag()
    return (ws.labels.clone(), ws.hood_e.clone(), ws.votes.clone(), flag, *ws.stats.clone())


def check_map_iteration(torch, ops, E, em_mod, plan) -> dict:
    """The main path's entry (``TickWorkspace.step``) at a slice plan's real
    state, f32 and bf16: held to the plain MAP iteration on the card in
    ``compare_tick``'s tiers (flag words equal at f32), to the JAX-signature
    entry of the same kernel bit for bit, and for K >= 9 to the plain MAP
    iteration on the CPU bit for bit (``check_tick_against_cpu``'s rule)."""
    st = real_map_state(torch, plan, E, em_mod)
    hoods, model = plan.problem.hoods, plan.problem.model
    n_labels = model.n_labels
    y, w, nall_e, validf = st["elements"]
    xf = st["labels"][hoods.vertex.long()].float() * validf
    entry_args = (y, w, nall_e, xf, validf, hoods.hood_id, hoods.vertex, model.region_mean,
                  model.region_weight, newest_first(st["ring"], st["head"]), st["mu"], st["sig"],
                  model.beta)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1, offsets=hoods.offsets)
    out = {"K": n_labels}
    for precision in ("f32", "bf16"):
        what = f"MAP iteration slice K={n_labels} {precision}"
        k = map_step(map_step_workspace(ops, em_mod, hoods, model, st, precision))
        p = map_step(map_step_workspace(ops, em_mod, hoods, model, st, precision, backend="torch"))
        err = compare_tick(torch, k, p, precision, what)
        if precision == "f32" and k[3] != p[3]:
            fail(f"{what}: flag word {k[3]}, plain {p[3]}")
        e = ops.fused_em_tick(*entry_args, precision=precision, **kw)
        same_entry = (bool(e[3]) == bool(k[3] & ops.FLAG_CONVERGED) and
                      all(same_bits(torch, a, b) for a, b in zip(k[:3] + k[4:], e[:3] + e[4:])))
        if not same_entry:
            fail(f"{what}: the workspace step and the JAX-signature entry of the same kernel differ")
        row = {"phase": "map_iteration_check", "operands": "512x512 slice", "K": n_labels,
               "precision": precision, "ok": True, "max_abs_err": err, "flag": k[3],
               "plain_flag": p[3], "equal_jax_signature_entry": same_entry}
        if n_labels >= 9:
            cpu = st["cpu"]
            c = map_step(map_step_workspace(ops, em_mod, cpu["hoods"], cpu["model"], cpu, precision))
            same_log = torch.equal(torch.log(st["sig"][:, None]).cpu(), torch.log(cpu["sig"][:, None]))
            unequal = [n for n, a, b in zip(TICK_OUTPUTS, k, c)
                       if (a != b if n == "conv" else not same_bits(torch, a.cpu(), b))]
            row.update(bitwise_equal_plain_cpu=not unequal, log_sigma_equal_cpu=same_log)
            if unequal:
                row["unequal"] = unequal
            if precision == "f32" and not set(unequal) <= (set() if same_log else {"hood_e"}):
                fail(f"{what}: {unequal} not bitwise equal to the plain MAP iteration on the CPU")
        if precision == "f32":
            out["max_abs_err"] = err
        emit(row)
    return out


def check_tick_step(torch, ops, E, em_mod, plan) -> dict:
    """The main path's MAP step at a slice plan's real state (f32):

    * repeat: ``MAP_STEPS`` steps, each from the same labels, ring and
      head, give the same bits (labels, hood_e, votes, sums, ring, flag),
      so the kernel resets its ticket, its vote buffer and its flag
      accumulator itself;
    * profiler: ``MAP_STEPS`` steps with their flag reads issue exactly one
      kernel each (the tick), no memset and at most one device-to-host
      copy each;
    * times: ms per MAP step (step and flag, host clock, what the driver
      pays), ms per step back to back (CUDA events), device us per step
      (profiler), the plain MAP iteration's ms, and the bound.
    """
    st = real_map_state(torch, plan, E, em_mod)
    hoods, model = plan.problem.hoods, plan.problem.model
    n_labels = model.n_labels
    ws = map_step_workspace(ops, em_mod, hoods, model, st)
    first = None
    for _ in range(MAP_STEPS):
        load_state(ws, st)
        got = map_step(ws) + (ws.ring.clone(),)
        first = first or got
        if not all(a == b if isinstance(a, int) else same_bits(torch, a, b) for a, b in zip(got, first)):
            fail(f"MAP step K={n_labels}: {MAP_STEPS} steps from one state differ")
    emit({"phase": "map_step_repeat_check", "K": n_labels, "steps": MAP_STEPS, "ok": True,
          "flag": first[3]})

    # The profiler has dropped a kernel's record (19 of 20 in one run): an
    # attempt that shows fewer tick kernels than steps and nothing else is
    # made again, up to PROFILE_ATTEMPTS times.  Any attempt that shows
    # another kernel, a memset or more copies than steps fails at once.
    steps = lambda: [(ws.step(True), ws.flag()) for _ in range(MAP_STEPS)]
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        load_state(ws, st)
        before = ops.launch_counts()["fused_em_tick"]
        prof = device_profile(torch, steps)
        ticks = sum(t["count"] for t in prof["top"] if "tick_kernel" in t["name"])
        a = {"launches": ops.launch_counts()["fused_em_tick"] - before, "kernels": prof["kernels"],
             "tick_kernels": ticks, "memsets": prof["memsets"], "memcpys": prof["memcpys"],
             "device_us_per_step": prof["device_busy_us"] / max(ticks, 1)}
        attempts.append(a)
        if (a["launches"] != MAP_STEPS or a["kernels"] != ticks or ticks > MAP_STEPS
                or a["memsets"] or a["memcpys"] > MAP_STEPS):
            fail(f"MAP step K={n_labels}: {MAP_STEPS} steps issued {a}")
        if ticks == MAP_STEPS:
            break
    row = {"phase": "map_step_profile_check", "K": n_labels, "steps": MAP_STEPS, **a,
           "attempts": len(attempts)}
    emit(row)
    if ticks != MAP_STEPS:
        fail(f"MAP step K={n_labels}: no profile of {MAP_STEPS} steps saw all of them: {attempts}")

    load_state(ws, st)
    n = 10 * MAP_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        ws.step(True)
        ws.flag()
    out = {"K": n_labels, "ms_per_map_step": (time.perf_counter() - t0) / n * 1e3,
           "ms": time_ms(lambda: ws.step(True)), "device_ms": row["device_us_per_step"] * 1e-3}
    plain = map_step_workspace(ops, em_mod, hoods, model, st, backend="torch")
    out["plain_ms"] = time_ms(lambda: plain.step(True))
    n_run = int(hoods.offsets[-1] - hoods.offsets[0])
    nh, nv, rows = hoods.n_hoods, hoods.n_regions + 1, em_mod.WINDOW + 1
    n_bytes = (n_run * 5 * 4 + nv * 4 + (nh + 1) * 4 + 2 * nv * 4 + (rows - 1) * nh * 4
               + 2 * n_labels * 4 + 4                               # inputs (labels gathered once)
               + nh * 4 + nh * 4 + nv * 4 + 2 * n_labels * nv * 4  # ring row, hood_e, labels, votes, cleared votes
               + 3 * n_labels * 4 + 2 * 4)                          # sums, flag words
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_run * n_labels * 16 + nv * 6)
    out["bytes"] = n_bytes
    emit({"phase": "timing", "what": f"MAP step (TickWorkspace) K={n_labels}", **out})
    return out


def warm_solve_ops(torch, api, plan, config) -> dict:
    """Device operations of one warm single-device solve of ``plan`` (the
    workspace built by an earlier solve), from ``torch.profiler``."""
    seg = api.Segmenter(config, device=plan.problem.hoods.vertex.device)
    wall = seg.execute(plan, seed=SLICE["seed"]).optimize_seconds
    prof = device_profile(torch, lambda: seg.execute(plan, seed=SLICE["seed"]))
    out = {"phase": "warm_solve_device_ops", "K": config.n_labels, "optimize_s_unprofiled": wall,
           **{k: prof[k] for k in ("device_ops", "kernels", "memsets", "memcpys", "device_busy_us")},
           "top": prof["top"]}
    emit(out)
    return out


def real_add_cases(torch, oversegment, sl) -> list:
    """The main path's float ``add`` calls at a slice, as order-free cases:
    the solve's neighbourhood sizes (``energy.make_static_context``: hood
    validity by hood id into n_hoods + 1, ids hood-sorted) and the plan's
    region intensity sums (``graph.region_stats``: the pixels by SLIC
    superpixel into n_regions, raster order)."""
    hoods, config = sl["plan"].problem.hoods, sl["config"]
    image = sl["image"].to(torch.float32)
    labels_px = oversegment.slic(image, grid=config.overseg_grid, iters=config.overseg_iters,
                                 device=image.device)
    n_regions = config.overseg_grid[0] * config.overseg_grid[1]
    np_ = lambda t: t.reshape(-1).cpu().numpy()
    return [
        ("solve: neighbourhood sizes", np_(hoods.valid.float()), np_(hoods.hood_id), hoods.n_hoods + 1),
        ("plan: region intensity sums", np_(image), np_(labels_px.to(torch.int32)), n_regions),
    ]


def segment_reduce_timing(torch, ops, hoods, profile: bool) -> dict:
    """``segment_reduce`` timed at the solve's call (``add`` of the hoods'
    validity into n_hoods + 1 segments) and, for ``min``, at the shape of
    the faithful mode's per-element minimum (``repro/core/pmrf/energy.py``
    min over K = 2 label energies: 2 x capacity values by hood-element lane,
    sorted, into capacity + 1 segments; normal values from a seed).  Each
    beside its plain version, one library call (``index_add_``;
    ``scatter_reduce_(..., "amin")``) and its bound; device time under
    ``--profile``."""
    dev = hoods.hood_id.device
    validf = hoods.valid.float()
    n_seg = hoods.n_hoods + 1
    ids_long = hoods.hood_id.long()
    lib_out = torch.zeros(n_seg, device=dev)
    add = lambda: ops.segment_reduce(validf, hoods.hood_id, n_seg, "add")
    if not torch.equal(add(), lib_out.index_add_(0, ids_long, validf)):
        fail("segment_reduce and index_add_ disagree on the neighbourhood sizes")
    n = hoods.capacity
    out = {"ms": time_ms(add),
           "plain_ms": time_ms(lambda: ops.segment_reduce(validf, hoods.hood_id, n_seg, "add",
                                                          backend="torch")),
           "library_ms": time_ms(lambda: lib_out.zero_().index_add_(0, ids_long, validf)),
           "shape": [n, n_seg]}
    out["bound_ms"], out["bound_by"] = bound(n * 8 + n_seg * 4, n)

    lane = torch.arange(n, dtype=torch.int32, device=dev)
    min_ids = torch.where(hoods.valid, lane, n).repeat(2).sort().values.contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    min_vals = torch.randn(2 * n, generator=gen, device=dev)
    min_ids_long = min_ids.long()
    inf_out = torch.full((n + 1,), float("inf"), device=dev)
    mn = lambda: ops.segment_reduce(min_vals, min_ids, n + 1, "min")
    lib_min = lambda: inf_out.fill_(float("inf")).scatter_reduce_(0, min_ids_long, min_vals, "amin")
    if not torch.equal(mn(), lib_min()):
        fail("segment_reduce min and scatter_reduce_ amin disagree")
    mins = {"ms": time_ms(mn),
            "plain_ms": time_ms(lambda: ops.segment_reduce(min_vals, min_ids, n + 1, "min",
                                                           backend="torch")),
            "library_ms": time_ms(lib_min), "shape": [2 * n, n + 1]}
    mins["bound_ms"], mins["bound_by"] = bound(2 * n * 8 + (n + 1) * 4, 2 * n)
    if profile:
        for what, fn, row in (("add at the solve's call", add, out), ("min, faithful shape", mn, mins)):
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            emit({"phase": "profile", "what": f"20 segment_reduce calls ({what})", **prof})
            row["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
        for what, fn, row in (("index_add_", lambda: lib_out.zero_().index_add_(0, ids_long, validf), out),
                              ("scatter_reduce_ amin", lib_min, mins)):
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            row["library_device_ms"] = prof["device_busy_us"] / 20 * 1e-3
    out["min"] = mins
    emit({"phase": "timing", "what": "segment_reduce", **out})
    return out


def problem_on_cpu(plan, config, seed: int):
    """The plan's problem (hoods, model, initial labels and parameters, the
    same as on the card) copied to the CPU."""
    from repro_torch.core.pmrf import convert, pipeline

    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, seed, config.init)
    d = {f: getattr(prob.hoods, f) for f in convert.HOODS_ARRAYS + convert.HOODS_SIZES}
    d.update({f: getattr(prob.model, f) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu0, sigma0=sigma0)
    return convert.problem_from_numpy(d, device="cpu")


def plain_solve_on_cpu(plan, config, seed: int):
    """The plan's solve on the plain path with the problem copied to the
    CPU, where the keyed sums add in element order (the JAX package's
    order); the same initial parameters as on the card."""
    from repro_torch.core.pmrf import em as em_mod, pipeline

    t0 = time.perf_counter()
    res = em_mod.run_em(*problem_on_cpu(plan, config, seed), config.with_(backend="torch").em_config())
    return pipeline.assemble_result(plan.problem, res, plan.init_seconds, time.perf_counter() - t0)


def run_slice(torch, api, metrics, synthetic, ops, dev, n_labels: int, n_phases: int = 0) -> dict:
    """The main path: a 512x512 slice planned and solved through the
    session API, with the launch counts reset just before and read just
    after; then the same plan solved on the plain path for comparison.
    The image has ``n_phases`` phases (default ``n_labels``).  The solve
    must give the status and iteration counts of the plain path on the
    CPU, which sums in element order (``plain_solve_on_cpu``; the card's
    plain path adds by atomics): K = 2 7 EM / 32 MAP iterations, K = 3
    10 / 46, K = 9 on the three-phase image (the tick's runtime-K variant,
    which sums in element order too) 17 / 99."""
    size, grid, seed = SLICE["size"], SLICE["grid"], SLICE["seed"]
    n_phases = n_phases or n_labels
    if n_phases == 2:
        vol = synthetic.make_synthetic_volume(seed=seed, n_slices=1, shape=(size, size), device=dev)
    else:
        vol = synthetic.make_kary_volume(seed=seed, n_slices=1, shape=(size, size), n_phases=n_phases, device=dev)
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
    emit({"phase": "problem_sizes", "K": n_labels, "phases": n_phases, **sizes})

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
        "phase": "slice", "K": n_labels, "phases": n_phases, "size": size, "grid": grid,
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
    cpu = plain_solve_on_cpu(plan, config, seed)
    emit({"phase": "slice_plain_cpu", "K": n_labels, "status": cpu.status,
          "em_iters": cpu.em_iters, "map_iters": cpu.map_iters, "accuracy": accuracy(cpu),
          "pixel_agreement": float((res.segmentation == cpu.segmentation).mean())})
    trajectory = lambda r: (r.status, r.em_iters, r.map_iters)
    if trajectory(res) != trajectory(cpu):
        fail(f"K={n_labels} solve: status and iterations {trajectory(res)}, "
             f"plain path on the CPU {trajectory(cpu)}")
    out.update(plan=plan, config=config, result=res, accuracy_of=accuracy, image=vol.images[0])
    return out


def map_step_operands(torch, plan, E, em_mod, hoods):
    """The ``fused_map_step`` call of the first MAP iteration of a sharded
    solve of ``plan`` on ``hoods`` (the plan's or a partition of them):
    ``cnt_e`` counts the quantile-init labels in each hood."""
    prob = plan.problem
    sctx = E.make_static_context(hoods, prob.model, backend="torch")
    labels, mu, sigma = em_mod.quantile_init(prob.graph.region_mean, prob.graph.n_regions, prob.model.n_labels)
    return E.map_step_operands(hoods, prob.model, sctx, labels, mu, sigma, backend="torch")


def compare_map_step(torch, k, p, what: str) -> float:
    """Hold a kernel MAP step ``k`` against the plain one ``p``; returns the
    largest absolute error over the four outputs."""
    names = ("min_e", "arg", "hood_e", "votes")
    err = max((a.float() - b.float()).abs().max().item() if a.numel() else 0.0 for a, b in zip(k, p))
    for name, a, b in zip(names, k, p):
        if name == "hood_e":
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
                fail(f"{what}: hood_e differs beyond rtol 1e-5 (err {err})")
        elif not torch.equal(a, b):
            fail(f"{what}: {name} differs")
    return err


def check_map_step(torch, ops, D, E, em_mod, plan, n_labels: int):
    """fused_map_step at the slice's operands against its plain version,
    then on each element block of a four-way partition: the blocks' votes
    must add up to the whole problem's exactly.  Returns ``(err, args,
    kw)``."""
    hoods = plan.problem.hoods
    args, kw = map_step_operands(torch, plan, E, em_mod, hoods)
    k = ops.fused_map_step(*args, **kw)
    p = ops.fused_map_step(*args, **kw, backend="torch")
    torch.cuda.synchronize()
    err = compare_map_step(torch, k, p, f"fused_map_step K={n_labels}")

    parts = D.partition_hoods(hoods, 4)
    (y, w, cnt, nall, xf, valid, hid, vtx, mu, sig, beta), pkw = map_step_operands(torch, plan, E, em_mod, parts)
    block = parts.capacity // 4
    votes = torch.zeros_like(k[3])
    hood_e = torch.zeros_like(k[2])
    for s in range(4):
        sl = slice(s * block, (s + 1) * block)
        kb = ops.fused_map_step(y[sl], w[sl], cnt[:, sl].contiguous(), nall[sl], xf[sl], valid[sl],
                                hid[sl], vtx[sl], mu, sig, beta, **pkw)
        pb = ops.fused_map_step(y[sl], w[sl], cnt[:, sl].contiguous(), nall[sl], xf[sl], valid[sl],
                                hid[sl], vtx[sl], mu, sig, beta, **pkw, backend="torch")
        err = max(err, compare_map_step(torch, kb, pb, f"fused_map_step K={n_labels} block {s}"))
        votes += kb[3]
        hood_e += kb[2]
    torch.cuda.synchronize()
    if not torch.equal(votes, k[3]):
        fail(f"fused_map_step K={n_labels}: the four blocks' votes do not add up to the whole")
    if not torch.allclose(hood_e, k[2], rtol=1e-5, atol=1e-4):
        fail(f"fused_map_step K={n_labels}: the four blocks' hood sums differ from the whole")
    # The route's plurality vote takes the first maximum; check it on these votes.
    best, first = k[3][0].clone(), torch.zeros(k[3].shape[1], dtype=torch.int64, device=k[3].device)
    for l in range(1, n_labels):
        take = k[3][l] > best
        best = torch.where(take, k[3][l], best)
        first = torch.where(take, l, first)
    if not torch.equal(torch.argmax(k[3], dim=0), first):
        fail(f"fused_map_step K={n_labels}: argmax over the votes does not take the first maximum")
    top2 = k[3].topk(2, dim=0).values
    tied = int(((top2[0] == top2[1]) & (top2[0] > 0)).sum().item())
    emit({"phase": "fused_map_step_check", "operands": "512x512 slice, quantile-init counts",
          "K": n_labels, "ok": True, "max_abs_err": err, "blocks": 4, "block": block,
          "votes_cast": int(k[3].sum().item()), "tied_vertices": tied})
    return err, args, kw


def check_map_step_long_hoods(torch, ops, dev) -> float:
    """fused_map_step on hoods of 100 and 300 elements, each spanning 4 to
    11 warps (``tick_problems.long_hood_map_step_problem``), K = 2 and 3:
    20 calls give bitwise equal hood sums, equal bit for bit to the numpy
    model of the order-free sum over the kernel's ``min_e * valid``; against
    the plain version the tiers of ``compare_map_step``.  Returns the
    largest error against the plain version."""
    from repro_torch.testing import segsum
    from repro_torch.testing.tick_problems import long_hood_map_step_problem

    worst, rows = 0.0, []
    for n_labels in (2, 3):
        arrays, kw = long_hood_map_step_problem(n_labels, n_labels)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        k = ops.fused_map_step(*args, 0.75, **kw)
        p = ops.fused_map_step(*args, 0.75, **kw, backend="torch")
        torch.cuda.synchronize()
        worst = max(worst, compare_map_step(torch, k, p, f"fused_map_step long hoods K={n_labels}"))
        first = bits(k[2])
        repeats_equal = all(np.array_equal(bits(ops.fused_map_step(*args, 0.75, **kw)[2]), first)
                            for _ in range(REPEATS - 1))
        valid, hood_id = arrays[5], arrays[6]
        part = k[0].cpu().numpy() * valid
        keys = np.where(valid > 0, hood_id, -1).astype(np.int32)
        model_equal = np.array_equal(segsum.segment_sum(part, keys, kw["n_hoods"]).view(np.uint32), first)
        row = {"K": n_labels, "hood_sizes": [100, 300], "elements": len(valid), "repeats": REPEATS,
               "hood_e_repeats_bitwise_equal": repeats_equal, "hood_e_model_bitwise_equal": model_equal}
        rows.append(row)
        if not (repeats_equal and model_equal):
            fail(f"fused_map_step long hoods: hood_e not order-fixed or not the model's: {row}")
    emit({"phase": "fused_map_step_long_hood_check", "ok": True, "max_abs_err": worst, "cases": rows})
    return worst


def check_mrf_energy(torch, ops, args) -> tuple:
    """mrf_min_energy at the K = 2 slice's operands, n1 = label-1 counts."""
    y, w, cnt, nall, xf, _valid, _hid, _vtx, mu, sig, beta = args
    margs = (y, w, cnt[1].contiguous(), nall, xf, mu, sig, beta)
    k = ops.mrf_min_energy(*margs)
    p = ops.mrf_min_energy(*margs, backend="torch")
    torch.cuda.synchronize()
    err = (k[0] - p[0]).abs().max().item()
    if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
        fail(f"mrf_min_energy: not exact (min_e err {err})")
    emit({"phase": "mrf_min_energy_check", "operands": "512x512 slice K=2", "ok": True,
          "max_abs_err": err, "label1_share": k[1].float().mean().item()})
    return err, margs


class CollectiveCount:
    """While active, counts ``torch.distributed.all_reduce`` calls (every
    collective of the sharded route is one) and, among them, the sharded
    driver's all-reduces of a step's buffer (``ReduceCtx.psum``) and ANDs of
    the flag word (``ReduceCtx.and_flags``)."""

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.core.pmrf import collectives

        self.n = {"all_reduce": 0, "psum": 0, "and_flags": 0}
        self._saved = [(dist, "all_reduce", dist.all_reduce)]
        self._saved += [(collectives.ReduceCtx, m, getattr(collectives.ReduceCtx, m))
                        for m in ("psum", "and_flags")]
        for owner, name, fn in self._saved:
            def counted(*a, _fn=fn, _name=name, **kw):
                self.n[_name] += 1
                return _fn(*a, **kw)
            setattr(owner, name, counted)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def run_sharded(torch, D, pipeline, ops, em_mod, sl) -> dict:
    """The sharded route on a slice's plan over the one-rank group, on the
    rank's workspace built beforehand (as the session builds it, outside
    the timed region): launch counts and collectives reset just before and
    read just after; then its plain path.  Both are held to the
    single-device result of the same plan.  Per MAP iteration the route
    makes one ``fused_map_step`` launch, one all-reduce and, past the
    window, the AND of the flag word, and per EM iteration one launch more
    (the one that stops the MAP loop); its label counts no longer go
    through ``segment_reduce``, which runs once for the neighbourhood sizes
    and three times per EM iteration for the M-step.  Its labels, iteration
    counts and status must equal the single-device route's (both sum in a
    fixed order); against its plain path on the card, which adds by
    atomics, the pixel and accuracy limits hold."""
    plan, config, single, accuracy = sl["plan"], sl["config"], sl["result"], sl["accuracy_of"]
    prob = plan.problem
    labels0, mu0, sigma0 = pipeline.initial_params(prob, SLICE["seed"], config.init)
    parts = D.partition_hoods(prob.hoods, 1)
    configs = {b: config.with_(backend=b).em_config() for b in ("auto", "torch")}
    workspaces = {b: D.make_workspace(parts, prob.model, c) for b, c in configs.items()}

    def solve(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=configs[backend],
                               workspace=workspaces[backend])
        torch.cuda.synchronize()
        return pipeline.assemble_result(prob, res, plan.init_seconds, time.perf_counter() - t0)

    ops.reset_launch_counts()
    with CollectiveCount() as coll:
        res = solve("auto")
    launches = ops.launch_counts()
    before = ops.launch_counts()
    res_p = solve("torch")
    if ops.launch_counts() != before:
        fail("the sharded plain path (backend='torch') launched a kernel")

    n_labels = sl["K"]
    acc, acc_p, acc_1 = accuracy(res), accuracy(res_p), sl["accuracy"]
    agree_1 = float((res.segmentation == single.segmentation).mean())
    agree_p = float((res.segmentation == res_p.segmentation).mean())
    iters = lambda r: (r.em_iters, r.map_iters)
    em_ands = max(res.em_iters - em_mod.WINDOW, 0)
    out = {
        "phase": "sharded_slice", "K": n_labels, "ranks": 1, "optimize_s": res.optimize_seconds,
        "em_iters": res.em_iters, "map_iters": res.map_iters, "status": res.status,
        "accuracy": acc, "launches": launches,
        "allreduces": coll.n["all_reduce"], "step_allreduces": coll.n["psum"],
        "flag_ands": coll.n["and_flags"], "em_ands": em_ands,
        "single_device_accuracy": acc_1, "pixel_agreement_single": agree_1,
        "labels_equal_single": bool(np.array_equal(res.region_labels, single.region_labels)),
        "iters_equal_single": iters(res) == iters(single),
        "status_equal_single": res.status == single.status,
        "plain_optimize_s": res_p.optimize_seconds, "plain_accuracy": acc_p,
        "plain_em_iters": res_p.em_iters, "plain_map_iters": res_p.map_iters,
        "pixel_agreement_plain": agree_p,
        "labels_equal_plain": bool(np.array_equal(res.region_labels, res_p.region_labels)),
        "iters_equal_plain": iters(res) == iters(res_p),
    }
    emit(out)
    if launches["fused_map_step"] != res.map_iters + res.em_iters:
        fail(f"fused_map_step launched {launches['fused_map_step']} times for {res.map_iters} MAP "
             f"and {res.em_iters} EM iterations")
    if launches["fused_em_tick"] != 0:
        fail("the sharded route ran the single-device tick")
    if launches["segment_reduce"] != 1 + 3 * res.em_iters:
        fail(f"segment_reduce launched {launches['segment_reduce']} times on the sharded route, "
             f"not once for the neighbourhood sizes and 3 per EM iteration: the label counts "
             f"went through it")
    # One all-reduce per MAP iteration, the flag ANDs, the EM window's ANDs,
    # the neighbourhood sizes and the two of the problem's fingerprint.
    if coll.n["psum"] != res.map_iters or coll.n["all_reduce"] != (
            coll.n["psum"] + coll.n["and_flags"] + em_ands + 3):
        fail(f"sharded K={n_labels} solve: collectives {coll.n} for {res.map_iters} MAP iterations")
    if res.status not in ("converged", "max_iters"):
        fail(f"sharded slice status {res.status}")
    if not (out["labels_equal_single"] and out["iters_equal_single"] and out["status_equal_single"]):
        fail(f"sharded K={n_labels} solve: labels, iterations or status differ from the single-device "
             f"route's on the same plan")
    for what, agree, ref_acc in (("single-device route", agree_1, acc_1), ("sharded plain path", agree_p, acc_p)):
        if agree < 0.995:
            fail(f"sharded route and {what} agree on {agree:.4f} of the pixels")
        if acc < ref_acc - 0.01:
            fail(f"sharded-route accuracy {acc} more than 0.01 below the {what}'s {ref_acc}")
    out["solve"] = lambda: solve("auto")
    return out


class LockstepWorkspace:
    """A kernel ``MapStepWorkspace`` that, at every launch, also steps a
    plain one (``backend="torch"``, on the card) from the same state and
    holds the two together: the head's labels, the flag word and the ring
    bit for bit, the step's votes exactly and its hood sums in the tiers of
    ``compare_map_step``; and the step's hood sums and votes bit for bit to
    the JAX-signature entry (``ops.fused_map_step``) on the same counts.
    Everything else is the kernel workspace's."""

    def __init__(self, torch, ops, kern, plain, hoods, model):
        self.torch, self.ops, self.kern, self.plain = torch, ops, kern, plain
        self.hoods, self.model = hoods, model
        self.launches = self.steps = 0
        self.worst = 0.0
        self.entry_equal = True

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def start(self, y, w, nall_e, valid, labels0):
        self.kern.start(y, w, nall_e, valid, labels0)
        self.plain.start(y, w, nall_e, valid, labels0)
        self.elements = (y, w, nall_e, valid)

    def begin_em(self, mu, sigma):
        self.kern.begin_em(mu, sigma)
        self.plain.begin_em(mu, sigma)
        self.params = (mu, sigma)

    def step(self, gate, step=True):
        torch, k, p = self.torch, self.kern, self.plain
        p._labels.copy_(k.labels)
        p._buffers.copy_(k._buffers)
        p.ring.copy_(k.ring)
        p.rot, p.head, p.first = k.rot, k.head, k.first
        k.step(gate, step)
        p.step(gate, step)
        self.launches += 1
        what = f"sharded MAP step K={k.n_labels} launch {self.launches}"
        fk, fp = k.flag(), p.flag()
        if fk != fp or not torch.equal(k.labels, p.labels) or not same_bits(torch, k.ring, p.ring):
            fail(f"{what}: flag {fk} / plain {fp}, or the labels or the ring differ")
        if not step:
            return
        self.steps += 1
        nh = k.n_hoods
        kb, pb = k.buffer, p.buffer
        if not torch.equal(kb[nh:], pb[nh:]):
            fail(f"{what}: votes differ from the plain step's")
        self.worst = max(self.worst, (kb[:nh] - pb[:nh]).abs().max().item())
        if not torch.allclose(kb[:nh], pb[:nh], rtol=1e-5, atol=1e-4):
            fail(f"{what}: hood_e differs from the plain step's beyond rtol 1e-5")
        # The JAX-signature entry on the counts of the labels this step used.
        h, n_labels = self.hoods, k.n_labels
        y, w, nall_e, valid = self.elements
        x = p.labels[h.vertex.long()]
        seg = torch.where(h.valid, h.hood_id.long(), nh)
        counts = self.ops.ref.keyed_sum(valid, seg * n_labels + x.long(), (nh + 1) * n_labels)
        cnt_e = counts.reshape(nh + 1, n_labels)[h.hood_id.long()].T.contiguous()
        e = self.ops.fused_map_step(y, w, cnt_e, nall_e, x.float() * valid, valid, h.hood_id,
                                    h.vertex, *self.params, self.model.beta, n_hoods=nh,
                                    n_vertices=k.n_vertices)
        if not (same_bits(torch, e[2], kb[:nh]) and torch.equal(e[3].reshape(-1), kb[nh:])):
            self.entry_equal = False
            fail(f"{what}: hood_e or votes differ from the JAX-signature entry's bits")


def check_sharded_map_step(torch, ops, D, pipeline, em_mod, sl, cpu_group, hold_cpu: bool) -> dict:
    """The sharded route's workspace kernel held to its plain version step
    by step over a whole sharded solve of the slice's plan (one rank,
    ``LockstepWorkspace``).  Beside it, the route's plain path with the
    problem copied to the CPU (``cpu_group``: a gloo group of the one
    rank), which sums in element order: where ``hold_cpu``, the solve's
    status and iteration counts must equal it, else they are reported
    (the kernel's order-free hood sums may part from element order at a
    threshold).  Returns the kernel workspace (its state is that of the
    solve's end) and the figures."""
    plan, config = sl["plan"], sl["config"]
    prob = plan.problem
    parts = D.partition_hoods(prob.hoods, 1)
    cfg, plain_cfg = config.em_config(), config.with_(backend="torch").em_config()
    kern = D.make_workspace(parts, prob.model, cfg)
    plain = D.make_workspace(parts, prob.model, plain_cfg)
    ws = LockstepWorkspace(torch, ops, kern, plain, parts, prob.model)
    labels0, mu0, sigma0 = pipeline.initial_params(prob, SLICE["seed"], config.init)
    res = D.run_em_sharded(parts, prob.model, labels0, mu0, sigma0, config=cfg, workspace=ws)
    hoods_c, model_c, *init_c = problem_on_cpu(plan, config, SLICE["seed"])
    cpu = D.run_em_sharded(D.partition_hoods(hoods_c, 1), model_c, *init_c, config=plain_cfg,
                           group=cpu_group)
    single = sl["result"]
    name = lambda r: em_mod.STATUS_NAMES.get(r.status, "running")
    trajectory = lambda r: [name(r), r.em_iters, r.map_iters]
    row = {"phase": "sharded_map_step_check", "K": sl["K"], "ok": True, "launches": ws.launches,
           "steps": ws.steps, "max_abs_err": ws.worst, "entry_bitwise_equal": ws.entry_equal,
           "status": name(res), "em_iters": res.em_iters, "map_iters": res.map_iters,
           "single_device": [single.status, single.em_iters, single.map_iters],
           "labels_equal_single": bool(np.array_equal(
               res.labels.cpu().numpy()[: prob.graph.n_regions], single.region_labels)),
           "plain_cpu": trajectory(cpu), "held_to_plain_cpu": hold_cpu,
           "labels_equal_plain_cpu": bool(torch.equal(res.labels.cpu(), cpu.labels))}
    emit(row)
    if ws.launches != res.map_iters + res.em_iters:
        fail(f"sharded K={sl['K']}: {ws.launches} launches for {res.map_iters} MAP and {res.em_iters} EM iterations")
    if hold_cpu and trajectory(res) != trajectory(cpu):
        fail(f"sharded K={sl['K']}: status and iterations {trajectory(res)}, the route's plain path "
             f"on the CPU {trajectory(cpu)}")
    return {"workspace": kern, "plain": plain, "max_abs_err": ws.worst, "parts": parts}


def check_sharded_step(torch, ops, collectives, checked, profile: bool) -> dict:
    """The sharded MAP iteration as the driver runs it (``step``, the AND of
    the flag word, the flag read, the all-reduce of the step's buffer) from
    the state a ``check_sharded_map_step`` solve ended in, K = 2:

    * profiler: ``MAP_STEPS`` iterations issue exactly one map-step kernel
      each, no memset, no copy, and no other kernel but NCCL's (counted
      apart);
    * times: ms per MAP iteration (host clock, what the driver pays; also
      without the flag AND, and without both collectives), ms per step
      back to back (CUDA events), device us per step (profiler), the plain
      workspace's step, and the bound.
    """
    import torch.distributed as dist

    ws, plain, parts = checked["workspace"], checked["plain"], checked["parts"]
    ctx = collectives.ReduceCtx(group=dist.group.WORLD)
    n_labels = ws.n_labels

    def iteration():
        ws.step(True)
        ctx.and_flags(ws.flag_word)
        ws.flag()
        ctx.psum(ws.buffer)

    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        before = ops.launch_counts()["fused_map_step"]
        prof = device_profile(torch, lambda: [iteration() for _ in range(MAP_STEPS)])
        steps = sum(t["count"] for t in prof["top"] if "map_iteration_kernel" in t["name"])
        nccl = sum(t["count"] for t in prof["top"] if "nccl" in t["name"].lower())
        step_us = sum(t["us"] for t in prof["top"] if "map_iteration_kernel" in t["name"])
        a = {"launches": ops.launch_counts()["fused_map_step"] - before, "kernels": prof["kernels"],
             "map_step_kernels": steps, "nccl_kernels": nccl, "memsets": prof["memsets"],
             "memcpys": prof["memcpys"], "device_us_per_step": step_us / max(steps, 1)}
        attempts.append(a)
        if (a["launches"] != MAP_STEPS or a["kernels"] != steps + nccl or steps > MAP_STEPS
                or a["memsets"] or a["memcpys"]):
            fail(f"sharded MAP iteration K={n_labels}: {MAP_STEPS} iterations issued {a}")
        if steps == MAP_STEPS:
            break
    row = {"phase": "sharded_step_profile_check", "K": n_labels, "steps": MAP_STEPS, **a,
           "attempts": len(attempts)}
    emit(row)
    if steps != MAP_STEPS:
        fail(f"sharded MAP iteration K={n_labels}: no profile of {MAP_STEPS} steps saw all of them: {attempts}")

    def host_ms(fn, n=10 * MAP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    # The iteration and its parts: the step with its flag read, then with
    # the all-reduce of the step, then the whole (with the flag AND).
    out = {"K": n_labels, "ms_per_map_iteration": host_ms(iteration),
           "ms_step_and_flag": host_ms(lambda: (ws.step(True), ws.flag())),
           "ms_step_flag_allreduce": host_ms(lambda: (ws.step(True), ws.flag(), ctx.psum(ws.buffer))),
           "ms": time_ms(lambda: ws.step(True)), "device_ms": row["device_us_per_step"] * 1e-3,
           "plain_ms": time_ms(lambda: plain.step(True))}
    from repro_torch.kernels import map_step

    ranges = map_step.hood_runs(parts, 0, 1)[0]
    # Each input byte once: y, w, nall and valid (f32) of the rank's own
    # elements; vertex (i32) and valid (bool) of the whole runs it counts,
    # which hold its own elements.
    n_run = int((ranges[:, 3] - ranges[:, 2]).sum())      # this rank's elements
    n_count = int((ranges[:, 1] - ranges[:, 0]).sum())    # the whole runs it counts
    nh, nv, rows = ws.n_hoods, ws.n_vertices, ws.ring.shape[0]
    n_bytes = (n_run * 4 * 4 + n_count * 5 + ranges.size * 4 + 2 * n_labels * 4 + 4  # elements, runs
               + nh * 4 + n_labels * nv * 4 + (rows - 1) * nh * 4                   # previous step, ring
               + nh * 4 + nv * 4                                                     # ring row, labels
               + nh * 4 + 2 * n_labels * nv * 4 + 4)                                 # step, cleared votes, flag
    out["bound_ms"], out["bound_by"] = bound(n_bytes, n_run * n_labels * 16 + (n_count + nv) * n_labels)
    out["bytes"] = n_bytes
    if profile:
        out["profile_top"] = prof["top"]
    emit({"phase": "timing", "what": f"sharded MAP step (MapStepWorkspace) K={n_labels}", **out})
    return out


def check_plan_repeat(torch, api, sl) -> dict:
    """A second plan of the slice's image on the card equals the first (the
    main path's) bit for bit: the label map and every ``Hoods`` array
    (SLIC's centroid sums are ``segment_reduce``'s order-free ``add``).
    Also whether the card's plan equals the plain path's on the CPU,
    reported and not held: the image's normalisation reduces in another
    order there."""
    from repro_torch.core.pmrf import convert

    image, config, first = sl["image"], sl["config"], sl["plan"]
    again = api.Segmenter(config, device=image.device).plan(image)
    on_cpu = api.Segmenter(config, device="cpu").plan(image.cpu())

    def unequal(a, b):
        out = [] if np.array_equal(a.problem.labels_px, b.problem.labels_px) else ["labels_px"]
        ha, hb = a.problem.hoods, b.problem.hoods
        for f in convert.HOODS_ARRAYS:
            x, y = getattr(ha, f).cpu(), getattr(hb, f).cpu()
            if x.shape != y.shape or not torch.equal(x, y):
                out.append(f)
        return out + [f for f in convert.HOODS_SIZES if getattr(ha, f) != getattr(hb, f)]

    repeat, vs_cpu = unequal(first, again), unequal(first, on_cpu)
    emit({"phase": "plan_repeat_check", "K": sl["K"], "plans": 2, "ok": not repeat,
          "unequal": repeat, "plan_s": [first.init_seconds, again.init_seconds],
          "equal_cpu_plain_plan": not vs_cpu, "unequal_cpu_plain_plan": vs_cpu,
          "cpu_plan_s": on_cpu.init_seconds})
    if repeat:
        fail(f"two plans of one image differ in {repeat}")
    return {"equal_cpu_plain_plan": not vs_cpu}


def flash_inputs(torch, shape, dtype: str, dev, seed: int) -> tuple:
    """q, k, v for a (B, Hq, Hkv, S, D) case, made with numpy from ``seed``
    (the scales of ``tests/test_kernels.py``)."""
    b, hq, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    arrays = ((rng.standard_normal((b, hq, s, d)) * 0.3), (rng.standard_normal((b, hkv, s, d)) * 0.3),
              rng.standard_normal((b, hkv, s, d)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev, getattr(torch, dtype)) for a in arrays)


def flash_launch(ops, q, k, v, causal: bool) -> tuple:
    """One launch of the flash kernel; returns the output and the kernel
    the C entry point reported it ran (``flash_attention.launches_tc``)."""
    from repro_torch.kernels import flash_attention

    before = flash_attention.launches_tc
    out = ops.flash_attention(q, k, v, causal=causal)
    return out, "tensor_cores" if flash_attention.launches_tc > before else "cuda_cores"


def check_flash(torch, ops, dev) -> float:
    """flash_attention kernel against its plain version on the card: the
    reference tests' shapes and a ragged S in f32 and bf16, causal and not,
    the model's shapes in bf16 causal, and two more shapes of the bf16
    tensor-core kernel.  Each case names the kernel it went to.  Returns
    the largest error."""
    cases = [(sh, dt, c) for sh in FLASH_REF_SHAPES for dt in FLASH_TOL for c in (False, True)]
    cases += [(sh, "bfloat16", True) for sh in FLASH_MODEL_SHAPES]
    cases += [(sh, "bfloat16", c) for sh in FLASH_TC_SHAPES for c in (False, True)]
    worst, rows = 0.0, []
    for i, (shape, dtype, causal) in enumerate(cases):
        q, k, v = flash_inputs(torch, shape, dtype, dev, seed=i)
        kern, variant = flash_launch(ops, q, k, v, causal)
        plain = ops.flash_attention(q, k, v, causal=causal, backend="torch")
        torch.cuda.synchronize()
        what = f"flash_attention {shape} {dtype} causal={causal}"
        if kern.dtype != q.dtype or kern.shape != q.shape:
            fail(f"{what}: output {kern.dtype} {tuple(kern.shape)}")
        if not bool(torch.isfinite(kern.float()).all()):
            fail(f"{what}: non-finite output")
        err = (kern.float() - plain.float()).abs().max().item()
        tol = FLASH_TOL[dtype]
        if not torch.allclose(kern.float(), plain.float(), rtol=tol, atol=tol):
            fail(f"{what}: differs from the plain version beyond {tol} (err {err})")
        worst = max(worst, err)
        rows.append({"shape": list(shape), "dtype": dtype, "causal": causal, "max_abs_err": err,
                     "variant": variant})
    emit({"phase": "flash_attention_check", "ok": True, "max_abs_err": worst, "cases": rows})
    return worst


def check_flash_peaked(torch, ops, dev) -> float:
    """The bf16 tensor-core kernel against its plain version where the
    softmax is peaked (``repro_torch.testing.flash_cases``): q scaled by 10
    to 1000, so the running max moves from tile to tile and, in one case,
    ``exp`` overflows unless the max is subtracted.  Each output row's
    error over its largest |value| must stay within ``ROW_TOL``; every case
    must reach the tensor-core kernel.  Returns the largest such error."""
    from repro_torch.testing import flash_cases as fc

    worst, rows = 0.0, []
    for i, (shape, q_scale, causal) in enumerate(fc.PEAKED_CASES):
        arrays = fc.peaked_inputs(shape, q_scale, seed=100 + i)
        spread = fc.score_spread(*arrays[:2], causal)
        what = f"flash_attention peaked {shape} q x{q_scale} causal={causal}"
        if spread < fc.MIN_SPREAD:
            fail(f"{what}: scores spread by {spread}, less than {fc.MIN_SPREAD}")
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in arrays)
        kern, variant = flash_launch(ops, q, k, v, causal)
        plain = ops.flash_attention(q, k, v, causal=causal, backend="torch")
        torch.cuda.synchronize()
        if variant != "tensor_cores":
            fail(f"{what}: went to the {variant} kernel")
        err = fc.row_relative_error(kern.float().cpu().numpy(), plain.float().cpu().numpy())
        if not err <= fc.ROW_TOL:
            fail(f"{what}: a row differs from the plain version by {err} of its largest value, "
                 f"beyond {fc.ROW_TOL}")
        worst = max(worst, err)
        rows.append({"shape": list(shape), "q_scale": q_scale, "causal": causal, "score_spread": spread,
                     "row_relative_err": err,
                     "max_abs_err": (kern.float() - plain.float()).abs().max().item()})
    emit({"phase": "flash_attention_peaked_check", "ok": True, "row_tol": fc.ROW_TOL,
          "row_relative_err": worst, "cases": rows})
    return worst


def lm_prompts(cfg) -> list:
    """The LM path's prompts: ``per_length`` of each length, from
    ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(LM["seed"])
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LM["lengths"] for _ in range(LM["per_length"])]


def serve(torch, serving, cfg, params, prompts, dev, backend: str, max_new: int = 0) -> dict:
    """Drive ``ServingEngine`` (greedy) over ``prompts``, all submitted at
    the start.  Each request's prefill time (its ``_insert``: one prefill
    and the first token's read, which waits for the card) and the moment
    its first token is known are recorded beside the completions.
    ``max_new`` defaults to the LM path's."""

    class TimedEngine(serving.ServingEngine):
        def _insert(self, slot, req):
            t0 = time.perf_counter()
            super()._insert(slot, req)
            t1 = time.perf_counter()
            prefill_s[req.rid], first_at[req.rid] = t1 - t0, t1

    prefill_s, first_at = {}, {}
    engine = TimedEngine(cfg, params, max_batch=LM["max_batch"], max_seq=LM["max_seq"],
                         sampler=serving.SamplerConfig(temperature=0.0), seed=LM["seed"],
                         device=dev, backend=backend)
    for rid, p in enumerate(prompts):
        engine.submit(serving.Request(rid=rid, prompt=p, max_new_tokens=max_new or LM["max_new"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"completions": {c.rid: c for c in comps}, "wall_s": wall, "ticks": engine.ticks,
            "prefill_s": prefill_s, "ttft_s": {r: t - t0 for r, t in first_at.items()}}


def prefill_last_logits(torch, api, cfg, params, prompts, dev, backend: str) -> list:
    """Last-position prefill logits (V,) float32 of each prompt."""
    out = []
    with torch.inference_mode():
        for p in prompts:
            tokens = torch.from_numpy(p.astype(np.int64))[None].to(dev)
            logits, _ = api.prefill(params, {"tokens": tokens}, cfg, backend=backend)
            out.append(logits[0, -1])
    torch.cuda.synchronize()
    return out


def run_lm(torch, ops, dev, profile: bool) -> dict:
    """The LM serving path at qwen2-1.5b's full width and depth, then the
    kernel path held against the plain path: (a) a 2-layer f32 variant at
    full width, (b) the 28-layer bf16 model."""
    import dataclasses

    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_api

    cfg = get_config(LM["arch"])
    api = get_api(cfg)
    prompts = lm_prompts(cfg)
    n_req = len(prompts)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "lm_model", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.param_dtype,
          "params": n_params, "init_s": time.perf_counter() - t0})

    # Warm-up (cuBLAS handles and heuristics at these shapes): one request
    # of each length, outside the counted run.
    serve(torch, serving, cfg, params, [prompts[0], prompts[-1]], dev, "auto", max_new=2)

    from repro_torch.kernels import flash_attention

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    main = serve(torch, serving, cfg, params, prompts, dev, "auto")
    launches = ops.launch_counts()
    launches_tc = flash_attention.launches_tc
    comps = main["completions"]
    generated = sum(len(c.tokens) for c in comps.values())
    by_len = {n: [r for r, p in enumerate(prompts) if len(p) == n] for n in LM["lengths"]}
    out = {
        "phase": "lm_serve", "arch": cfg.name, "requests": n_req, "prompt_lengths": list(LM["lengths"]),
        "max_new_tokens": LM["max_new"], "max_batch": LM["max_batch"], "max_seq": LM["max_seq"],
        "launches": launches, "flash_attention_tensor_core_launches": launches_tc,
        "completed": len(comps), "generated_tokens": generated,
        "ticks": main["ticks"], "wall_s": main["wall_s"], "tok_per_s": generated / main["wall_s"],
        "ttft_s": [main["ttft_s"][r] for r in range(n_req)],
        "prefill_ms": {str(n): [main["prefill_s"][r] * 1e3 for r in rids] for n, rids in by_len.items()},
        "mean_prefill_ms": {str(n): float(np.mean([main["prefill_s"][r] for r in rids])) * 1e3
                            for n, rids in by_len.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    want = cfg.n_layers * n_req
    if launches["flash_attention"] != want:
        fail(f"flash_attention launched {launches['flash_attention']} times on the LM path, not {want}")
    if launches_tc != want:
        fail(f"{launches_tc} of the LM path's {want} flash_attention launches went to the tensor-core kernel")
    if any(n for name, n in launches.items() if name != "flash_attention"):
        fail(f"the LM path launched a segmentation kernel: {launches}")
    if sorted(comps) != list(range(n_req)):
        fail(f"LM path completed {sorted(comps)} of {n_req} requests")
    for rid, c in comps.items():
        if len(c.tokens) != LM["max_new"] or c.finish_reason != "length":
            fail(f"request {rid}: {len(c.tokens)} tokens, finish {c.finish_reason}")
        if not bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()):
            fail(f"request {rid}: token ids outside the vocabulary")

    # (a) 2 layers at full width in float32: kernel path against plain path.
    cfg_a = dataclasses.replace(cfg, n_layers=2, param_dtype="float32", compute_dtype="float32")
    params_a = api.init(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg_a)
    ops.reset_launch_counts()
    kern_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "auto")
    launches_a = ops.launch_counts()["flash_attention"]
    plain_a = serve(torch, serving, cfg_a, params_a, prompts, dev, "torch")
    logits_k = prefill_last_logits(torch, api, cfg_a, params_a, prompts, dev, "auto")
    before = ops.launch_counts()
    logits_p = prefill_last_logits(torch, api, cfg_a, params_a, prompts, dev, "torch")
    if ops.launch_counts() != before or launches_a != cfg_a.n_layers * n_req:
        fail(f"f32 check: plain path launched a kernel, or the kernel path launched {launches_a}")
    tokens_equal = all(np.array_equal(kern_a["completions"][r].tokens, plain_a["completions"][r].tokens)
                       for r in range(n_req))
    err_a = max((a - b).abs().max().item() for a, b in zip(logits_k, logits_p))
    close_a = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(logits_k, logits_p))
    res_a = {"layers": 2, "dtype": "float32", "greedy_tokens_equal": tokens_equal,
             "logits_max_abs_err": err_a, "logits_within_rtol_1e-4": close_a,
             "wall_s": kern_a["wall_s"], "plain_wall_s": plain_a["wall_s"]}

    # (b) the 28-layer bf16 model: first generated token and logits cosine.
    logits_k = prefill_last_logits(torch, api, cfg, params, prompts, dev, "auto")
    before = ops.launch_counts()
    logits_p = prefill_last_logits(torch, api, cfg, params, prompts, dev, "torch")
    if ops.launch_counts() != before:
        fail("bf16 check: the plain path launched a kernel")
    equal = [int(a.argmax() == b.argmax()) for a, b in zip(logits_k, logits_p)]
    first_equal = sum(equal)
    cos = [torch.nn.functional.cosine_similarity(a, b, dim=0).item() for a, b in zip(logits_k, logits_p)]
    engine_first = sum(int(comps[r].tokens[0] == int(logits_k[r].argmax())) for r in range(n_req))
    # Each request's top-1 minus top-2 logit on the plain path: a first
    # token that differs at a small margin is a near-tie, at a large one an error.
    top2 = [b.float().topk(2).values for b in logits_p]
    res_b = {"layers": cfg.n_layers, "dtype": cfg.param_dtype, "first_token_equal": first_equal,
             "of": n_req, "first_token_equal_by_request": equal,
             "plain_top1_minus_top2": [(t[0] - t[1]).item() for t in top2],
             "min_cosine": min(cos), "cosine": cos,
             "logits_max_abs_err": max((a - b).abs().max().item() for a, b in zip(logits_k, logits_p)),
             "engine_first_token_equal_kernel_prefill": engine_first}
    emit({"phase": "lm_kernel_vs_plain", "f32_2_layers": res_a, "bf16_28_layers": res_b})
    if not tokens_equal:
        fail("f32 2-layer model: greedy tokens differ between the kernel and plain paths")
    if not close_a:
        fail(f"f32 2-layer model: prefill logits differ beyond rtol 1e-4 (err {err_a})")
    if first_equal < n_req - 1:
        fail(f"bf16 model: first token equal on {first_equal} of {n_req} requests")
    if min(cos) < 0.99:
        fail(f"bf16 model: prefill logits cosine {min(cos)} below 0.99")
    del params_a

    if profile:
        long_prompt = torch.from_numpy(prompts[-1].astype(np.int64))[None].to(dev)

        def prefill():
            with torch.inference_mode():
                api.prefill(params, {"tokens": long_prompt}, cfg)

        cache = api.init_cache(cfg, LM["max_batch"], LM["max_seq"], device=dev)
        cache["t"] = torch.tensor(max(LM["lengths"]), dtype=torch.int32)
        last = torch.zeros((LM["max_batch"], 1), dtype=torch.int64, device=dev)

        def decode():
            with torch.inference_mode():
                api.decode_step(params, dict(cache), {"tokens": last}, cfg)

        for what, fn in ((f"prefill S={max(LM['lengths'])}", prefill),
                         (f"decode step B={LM['max_batch']} t={max(LM['lengths'])}", decode)):
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = device_profile(torch, fn)
            emit({"phase": "profile", "what": f"LM {what}, {cfg.n_layers} layers {cfg.param_dtype}",
                  "wall_s_unprofiled": min(walls),
                  "device_idle_share": 1.0 - prof["device_busy_us"] * 1e-6 / min(walls), **prof})
    return {"launches": launches["flash_attention"], "launches_tc": launches_tc, "serve": out}


def time_flash(torch, ops, dev, profile: bool) -> dict:
    """The flash kernel at the LM path's two calls (S = 512 and 1024, bf16,
    causal): its time per call (CUDA events over back-to-back calls, the
    host's share included) and on the device (``torch.profiler``), the
    plain version's time, one library call's (``scaled_dot_product_attention``,
    per call and on the device), and the bound from the call's bytes and
    operations, with the kernel's share of it.  Returns the S = 1024
    numbers for the ``kernels`` line, the S = 512 ones under ``by_shape``."""
    import torch.nn.functional as F

    rows = []
    for shape in FLASH_MODEL_SHAPES:
        b, hq, hkv, s, d = shape
        q, k, v = flash_inputs(torch, shape, "bfloat16", dev, seed=99)
        kern = lambda: ops.flash_attention(q, k, v, causal=True)
        plain = lambda: ops.flash_attention(q, k, v, causal=True, backend="torch")
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        lib_err = (lib().float() - plain().float()).abs().max().item()
        if lib_err > FLASH_TOL["bfloat16"]:
            fail(f"scaled_dot_product_attention differs from the plain version by {lib_err}")
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        prof = device_profile(torch, lambda: [kern() for _ in range(20)])
        lib_prof = device_profile(torch, lambda: [lib() for _ in range(20)])
        n_bytes = (2 * b * hq + 2 * b * hkv) * s * d * q.element_size()   # q, k, v in; out
        pairs = s * (s + 1) // 2                                          # causal (q, k) pairs
        n_ops = 4 * b * hq * d * pairs                                    # QK^T and PV, 2 ops per MAC
        bound_ms, by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        device_ms = prof["device_busy_us"] / 20 * 1e-3
        row = {"shape": list(shape), "variant": flash_launch(ops, q, k, v, True)[1],
               "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_device_ms": lib_prof["device_busy_us"] / 20 * 1e-3,
               "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / ms,
               "device_share_of_bound": bound_ms / device_ms if device_ms else None,
               "bytes": n_bytes, "ops": n_ops, "achieved_tflops": n_ops / (ms * 1e-3) / 1e12,
               "device_tflops": n_ops / (device_ms * 1e-3) / 1e12 if device_ms else None,
               "sdpa_max_abs_err_vs_plain": lib_err}
        emit({"phase": "timing", "what": "flash_attention bf16 causal", **row})
        if profile:
            emit({"phase": "profile", "what": f"20 flash_attention calls (S={s} bf16 causal)", **prof})
            emit({"phase": "profile", "what": f"20 scaled_dot_product_attention calls (S={s})", **lib_prof})
        rows.append(row)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms", "bound_by")
    return {**{k: rows[-1][k] for k in keys},
            "by_shape": {str(r["shape"][3]): {k: r[k] for k in keys} for r in rows}}


def flash_sass_hgmma() -> dict:
    """Count ``HGMMA`` (wgmma) instructions in the built flash_attention
    library's SASS with ``cuobjdump``; empty where the tool is absent."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._target("flash_attention"))],
                          capture_output=True, text=True, timeout=120).stdout
    return {"hgmma_in_sass": sum(line.count("HGMMA") for line in sass.splitlines())}


def ptxas_report(name: str) -> dict:
    """Registers, stack and spills of each kernel in ``csrc/<name>.cu``
    from the ``-Xptxas=-v`` report kept beside its library."""
    import re

    from repro_torch.kernels import _build

    log = _build._target(name).with_suffix(".log").read_text()
    out, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"kernel": m.group(1)}
            out.append(current)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return {"library": _build._target(name).name, "kernels": out,
            "spill_bytes": sum(k.get("spill_stores", 0) + k.get("spill_loads", 0) for k in out)}


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
    from repro_torch.core import metrics, oversegment, synthetic
    from repro_torch.core.pmrf import em as em_mod
    from repro_torch.core.pmrf import energy as E
    from repro_torch.kernels import _build, ops

    dev = torch.device(DEVICE)
    # float32 products in full float32 (the defaults, stated): the plain
    # versions the kernels are held to must not drop to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    emit({"device": {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi_line,
                     "torch": torch.__version__, "cuda": torch.version.cuda}})

    emit({"phase": "build", "build_s": _build.build_all(), "dir": str(_build.BUILD_DIR)})
    tick_ptxas = ptxas_report("em_tick")
    emit({"phase": "ptxas", **tick_ptxas})
    step_ptxas = ptxas_report("map_step")
    emit({"phase": "ptxas", **step_ptxas})
    ptxas = ptxas_report("flash_attention")
    emit({"phase": "ptxas", **ptxas,
          "kernels": [k for k in ptxas["kernels"] if "flash_attention_tc_kernel" in k["kernel"]]})
    if ptxas["spill_bytes"]:
        fail(f"flash_attention spills {ptxas['spill_bytes']} bytes (ptxas)")

    sr_err = check_segment_reduce(torch, ops, dev)
    check_segment_reduce_order_free(torch, ops, dev, random_add_cases())
    check_segment_reduce_nonfinite(torch, ops, dev)
    check_tick_synthetic(torch, ops, dev)
    flash_err = check_flash(torch, ops, dev)
    check_flash_peaked(torch, ops, dev)

    slice2 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=2)
    plan = slice2["plan"]
    check_plan_repeat(torch, api, slice2)

    hoods = plan.problem.hoods
    check_segment_reduce_order_free(torch, ops, dev, real_add_cases(torch, oversegment, slice2))
    tick2 = check_time_tick(torch, ops, E, em_mod, plan, profile)
    step2 = {**check_map_iteration(torch, ops, E, em_mod, plan),
             **check_tick_step(torch, ops, E, em_mod, plan)}
    solve_ops = warm_solve_ops(torch, api, plan, slice2["config"])

    # segment_reduce at the solve's call (neighbourhood sizes), and its min
    # at the shape of the faithful mode's per-element minimum.
    sr = segment_reduce_timing(torch, ops, hoods, profile)
    if profile:
        solve = api.Segmenter(
            api.ExecutionConfig(n_labels=2, overseg_grid=(SLICE["grid"],) * 2, init="quantile"), device=dev
        )
        profile_solve(torch, "K=2 slice solve (execute)", lambda: solve.execute(plan, seed=SLICE["seed"]))

    slice3 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=3)
    # K = 9 on the three-phase image: the tick's runtime-K variant on the main path.
    slice9 = run_slice(torch, api, metrics, synthetic, ops, dev, n_labels=9, n_phases=3)
    tick9 = check_time_tick(torch, ops, E, em_mod, slice9["plan"], profile)
    check_map_iteration(torch, ops, E, em_mod, slice3["plan"])
    step9 = {**check_map_iteration(torch, ops, E, em_mod, slice9["plan"]),
             **check_tick_step(torch, ops, E, em_mod, slice9["plan"])}

    # Second path: the sharded route's kernels at the slices' operands.
    from repro_torch.core.pmrf import collectives
    from repro_torch.core.pmrf import distributed as D
    from repro_torch.core.pmrf import pipeline

    ms_err, ms_args, ms_kw = check_map_step(torch, ops, D, E, em_mod, plan, 2)
    ms_err = max(ms_err, check_map_step(torch, ops, D, E, em_mod, slice3["plan"], 3)[0])
    ms_err = max(ms_err, check_map_step_long_hoods(torch, ops, dev))
    mrf_err, mrf_args = check_mrf_energy(torch, ops, ms_args)

    # The sharded route end to end, over a one-rank NCCL group.
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        sharded = {sl["K"]: run_sharded(torch, D, pipeline, ops, em_mod, sl) for sl in (slice2, slice3)}
        # The route's workspace kernel against its plain version and the
        # JAX-signature entry, step by step over whole solves, and the
        # solves against the route's plain path on the CPU (K = 9: the
        # sharded route at a K the main path does not take, reported).
        cpu_group = dist.new_group(backend="gloo")
        checked = {sl["K"]: check_sharded_map_step(torch, ops, D, pipeline, em_mod, sl, cpu_group,
                                                   hold_cpu=sl["K"] != 9)
                   for sl in (slice2, slice3, slice9)}
        sstep = check_sharded_step(torch, ops, collectives, checked[2], profile)
        if profile:
            for n_labels in (2, 3):
                profile_solve(torch, f"K={n_labels} sharded solve (run_em_sharded on its workspace, 1 rank)",
                              sharded[n_labels]["solve"])
            # The entry that partitions and builds the workspace in each call,
            # as earlier checkouts of this script profiled it.
            cfg2 = slice2["config"].em_config()
            init2 = pipeline.initial_params(plan.problem, SLICE["seed"], slice2["config"].init)

            def entry_solve():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = D.distributed_em(hoods, plan.problem.model, *init2, config=cfg2)
                torch.cuda.synchronize()
                return pipeline.assemble_result(plan.problem, res, plan.init_seconds, time.perf_counter() - t0)

            profile_solve(torch, "K=2 sharded solve (distributed_em, 1 rank)", entry_solve)
    finally:
        dist.destroy_process_group()

    # Timing of the JAX-signature map step and mrf_min_energy at the K = 2
    # slice's operands.
    ms_ms = time_ms(lambda: ops.fused_map_step(*ms_args, **ms_kw))
    ms_plain_ms = time_ms(lambda: ops.fused_map_step(*ms_args, **ms_kw, backend="torch"))
    mrf_ms = time_ms(lambda: ops.mrf_min_energy(*mrf_args))
    mrf_plain_ms = time_ms(lambda: ops.mrf_min_energy(*mrf_args, backend="torch"))
    h = int(ms_args[0].shape[0])
    nh, nv, k2 = ms_kw["n_hoods"], ms_kw["n_vertices"], 2
    ms_bytes = (h * (7 * 4 + k2 * 4) + 2 * k2 * 4 + 4      # inputs: 7 element arrays, cnt_e, mu, sigma, beta
                + h * 8 + nh * 4 + k2 * nv * 4)            # outputs: min_e, arg, hood_e, votes
    ms_bound, ms_by = bound(ms_bytes, h * (2 + 15 * k2))
    mrf_bytes = h * 5 * 4 + 2 * 2 * 4 + 4 + h * 8
    mrf_bound, mrf_by = bound(mrf_bytes, h * 32)
    ms_entry = {"ms": ms_ms, "plain_ms": ms_plain_ms, "bound_ms": ms_bound, "bound_by": ms_by}
    if profile:
        prof = device_profile(torch, lambda: [ops.fused_map_step(*ms_args, **ms_kw) for _ in range(20)])
        emit({"phase": "profile", "what": "20 fused_map_step calls (JAX-signature entry)", **prof})
        ms_entry["device_ms"] = prof["device_busy_us"] / 20 * 1e-3
        emit({"phase": "profile", "what": "20 mrf_min_energy calls",
              **device_profile(torch, lambda: [ops.mrf_min_energy(*mrf_args) for _ in range(20)])})
    emit({"phase": "timing", "fused_map_step_ms": ms_ms, "fused_map_step_plain_ms": ms_plain_ms,
          "mrf_min_energy_ms": mrf_ms, "mrf_min_energy_plain_ms": mrf_plain_ms,
          "fused_map_step_bytes": ms_bytes, "mrf_min_energy_bytes": mrf_bytes, "elements": h})

    # Third path: LM serving at qwen2-1.5b's full width and depth.
    lm = run_lm(torch, ops, dev, profile)
    flash = time_flash(torch, ops, dev, profile)

    launches = slice2["launches"]
    sharded_launches = sharded[2]["launches"]
    tick_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
    step_keys = tick_keys + ("ms_per_map_step",)
    emit({"kernels": [
        {"name": "fused_em_tick", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/em_tick.cu",
         "replaces": "src/repro/kernels/em_tick.py:253",
         "launches": launches["fused_em_tick"], **{k: step2[k] for k in step_keys},
         "library_ms": None, "device_ops_per_warm_solve": solve_ops["device_ops"],
         "ptxas": {"spill_bytes": tick_ptxas["spill_bytes"],
                   "registers": {k["kernel"]: k.get("registers") for k in tick_ptxas["kernels"]}},
         "jax_signature_entry": {k: tick2[k] for k in tick_keys if k in tick2},
         "K9": {"launches": slice9["launches"]["fused_em_tick"], **{k: step9[k] for k in step_keys},
                "jax_signature_entry": {k: tick9[k] for k in tick_keys if k in tick9}}},
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
         "replaces": "src/repro/kernels/segment_reduce.py:71",
         "launches": launches["segment_reduce"], "max_abs_err": sr_err, **sr},
        {"name": "fused_map_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/map_step.cu",
         "replaces": "src/repro/kernels/map_step.py:148",
         "launches": sharded_launches["fused_map_step"],
         "max_abs_err": max([ms_err] + [c["max_abs_err"] for c in checked.values()]),
         **{k: sstep[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                                  "ms_per_map_iteration")},
         "library_ms": None, "allreduces_per_solve": sharded[2]["allreduces"],
         "ptxas": {"spill_bytes": step_ptxas["spill_bytes"],
                   "registers": {k["kernel"]: k.get("registers") for k in step_ptxas["kernels"]}},
         "jax_signature_entry": ms_entry},
        {"name": "mrf_min_energy", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mrf_energy.cu",
         "replaces": "src/repro/kernels/mrf_energy.py:62",
         "launches": sharded_launches["mrf_min_energy"], "max_abs_err": mrf_err,
         "ms": mrf_ms, "plain_ms": mrf_plain_ms, "bound_ms": mrf_bound,
         "bound_by": mrf_by, "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:83",
         "launches": lm["launches"], "launches_tensor_cores": lm["launches_tc"],
         "max_abs_err": flash_err, **flash, **flash_sass_hgmma()},
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
