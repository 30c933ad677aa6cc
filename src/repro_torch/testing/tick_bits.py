"""What a checkout's EM tick computes, and what its warm solve issues, on
the card: for comparing two checkouts.

Run on a CUDA card from the root of a checkout::

    PYTHONPATH=src python3 -m repro_torch.testing.tick_bits

It plans the K = 2, 3 and 9 slices of ``chip_smoke.py`` on the card,
advances the plain path on the CPU (element-order sums, the same bits in
every run) to MAP iteration WINDOW+2 from the quantile init, and launches
the tick through its JAX-signature entry (``ops.fused_em_tick``) at f32
and bf16.  Each case prints one JSON line with the sha256 of the operands
and of every output: two checkouts whose lines agree compute the same
bits.  Where the checkout has the MAP-iteration workspace
(``ops.tick_workspace``), the line also says whether one step of it from
the same state gives the entry's bits.  A last line gives the device
operations (kernels, memsets, copies, from ``torch.profiler``) of one
warm K = 2 solve through ``Segmenter.execute``, the line before it the
host-clock ms per K = 2 MAP iteration as the checkout's driver runs it.  Beyond
the workspace it uses only the session API, the plain tick and the
tick's JAX-signature entry, which older checkouts of the port have too,
so the file copied into one of them runs there.
"""

from __future__ import annotations

import hashlib
import json
import time

import torch

from repro_torch import api
from repro_torch.core import synthetic
from repro_torch.core.pmrf import collectives, convert, pipeline
from repro_torch.core.pmrf import em as em_mod
from repro_torch.core.pmrf import energy as E
from repro_torch.kernels import ops, ref

CASES = ((2, 2), (3, 3), (9, 3))  # (labels, phases) of the slices
SIZE, GRID, SEED = 512, 32, 0
NAMES = ("labels", "hood_e", "votes", "conv", "sum_w", "sum_wy", "sum_wyy")


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def state_on_cpu(plan):
    """The CPU copy of the plan's problem and the tick's operands after
    WINDOW+1 plain iterations from the quantile init."""
    prob = plan.problem
    labels0, mu, sigma = pipeline.initial_params(prob, SEED, "quantile")
    d = {f: getattr(prob.hoods, f) for f in convert.HOODS_ARRAYS + convert.HOODS_SIZES}
    d.update({f: getattr(prob.model, f) for f in convert.MODEL_FIELDS})
    d.update(labels0=labels0, mu0=mu, sigma0=sigma)
    hoods, model, labels, mu, sigma = convert.problem_from_numpy(d, device="cpu")
    sctx = E.make_static_context(hoods, model, backend="torch")
    sig = torch.maximum(sigma, model.sigma_min)
    kw = dict(n_hoods=hoods.n_hoods, n_vertices=hoods.n_regions + 1)
    hist = torch.zeros((em_mod.WINDOW + 1, hoods.n_hoods))
    for _ in range(em_mod.WINDOW + 1):
        xf = labels[hoods.vertex.long()].float() * sctx.validf
        labels, hood_e, *_ = ref.fused_em_tick(
            sctx.y, sctx.w, sctx.nall_e, xf, sctx.validf, hoods.hood_id, hoods.vertex,
            model.region_mean, model.region_weight, hist, mu, sig, model.beta, **kw)
        hist = torch.cat([hood_e[None], hist[:-1]])
    xf = labels[hoods.vertex.long()].float() * sctx.validf
    args = (sctx.y, sctx.w, sctx.nall_e, xf, sctx.validf, hoods.hood_id, hoods.vertex,
            model.region_mean, model.region_weight, hist, mu, sig, model.beta)
    return args, kw, labels, sctx


def _bound_workspace(hoods, model, elements, labels, **kw):
    """The checkout's single-device workspace, bound to a solve: built from
    the bucket's shapes (``ops.TickShape``) where the checkout has them,
    else from the problem."""
    if hasattr(ops, "TickShape"):
        ws = ops.tick_workspace(ops.TickShape.of(hoods, model), device=hoods.vertex.device, **kw)
        ws.start(hoods, model, *elements, labels)
    else:
        ws = ops.tick_workspace(hoods, model, **kw)
        ws.start(*elements, labels)
    return ws


def _stopping_step(ws) -> None:
    """One gated step that takes the M-step sums (on checkouts whose
    workspace takes them only in the launch that stops the MAP loop, the
    cap bit)."""
    if hasattr(ops, "TickShape"):
        ws.step(True, True)
    else:
        ws.step(True)


def workspace_bits(plan, args, labels, sctx, precision):
    """One step of the checkout's workspace from the same state (the ring
    holding ``hist`` with head 0), as the entry's outputs."""
    dev = plan.problem.hoods.vertex.device
    ws = _bound_workspace(plan.problem.hoods, plan.problem.model,
                          [t.to(dev) for t in (sctx.y, sctx.w, sctx.nall_e, sctx.validf)],
                          labels.to(dev), precision=precision, conv_tol=em_mod.CONV_TOL,
                          window=em_mod.WINDOW)
    ws.begin_em(args[10].to(dev), args[11].to(dev))
    ws.ring.copy_(args[9])
    ws.head = 0
    _stopping_step(ws)
    flag = ws.flag()
    conv = torch.tensor(bool(flag & ops.FLAG_CONVERGED))
    return (ws.labels, ws.hood_e, ws.votes, conv, *ws.stats)


def map_step_ms(plan, args, labels, sctx, steps: int = 200) -> dict:
    """Host-clock ms per MAP iteration at f32, from the state of
    ``state_on_cpu``, as the checkout's single-device driver runs it: with
    the workspace, ``step`` and ``flag``; before it, the body of the
    driver's MAP loop (the tick call with its gather, the M-step stack, the
    ``torch.cat`` ring, the finiteness test, the gated stop and its read),
    with the gate open."""
    hoods, model = plan.problem.hoods, plan.problem.model
    dev = hoods.vertex.device
    mu, sig, hist = (args[i].to(dev) for i in (10, 11, 9))
    labels = labels.to(dev)
    card = [t.to(dev) for t in (sctx.y, sctx.w, sctx.nall_e, sctx.validf)]
    if hasattr(ops, "tick_workspace"):
        ws = _bound_workspace(hoods, model, card, labels, conv_tol=em_mod.CONV_TOL,
                              window=em_mod.WINDOW)
        ws.begin_em(mu, sig)
        ws.ring.copy_(hist)

        def one():
            ws.step(True)
            ws.flag()
    else:
        sctx_card = E.StaticMapContext(y=card[0], w=card[1], nall_e=card[2], validf=card[3])

        def one():
            nonlocal labels, hist
            labels, hood_e, conv, sw, swy, swyy = E.em_tick_fused(
                hoods, model, sctx_card, labels, mu, sig, hist, precision="f32",
                conv_tol=em_mod.CONV_TOL)
            torch.stack([sw, swy, swyy])
            hist = torch.cat([hood_e[None], hist[:-1]])
            diverged = ~torch.all(torch.isfinite(hood_e))
            bool(collectives.LOCAL.all_converged(conv) | diverged)
    for _ in range(10):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    return {"map_step_K": model.n_labels, "steps": steps,
            "ms_per_map_step": (time.perf_counter() - t0) / steps * 1e3,
            "route": "workspace" if hasattr(ops, "tick_workspace") else "driver loop body"}


def warm_solve_ops(plan, config) -> dict:
    """Device operations of one warm solve of ``plan`` (after one untraced
    solve); the card first spins for about 10 ms inside the trace, as the
    profiler drops the records of a trace's first milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seg = api.Segmenter(config, device=plan.problem.hoods.vertex.device)
    wall = seg.execute(plan, seed=SEED).optimize_seconds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        seg.execute(plan, seed=SEED)
    kinds = {"kernels": 0, "memsets": 0, "memcpys": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key:
            kind = "memsets" if e.key.startswith("Memset") else "memcpys" if e.key.startswith("Memcpy") else "kernels"
            kinds[kind] += e.count
    return {"warm_solve_K": config.n_labels, "device_ops": sum(kinds.values()), **kinds,
            "first_solve_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("tick_bits: no CUDA device")
        return 2
    dev = torch.device("cuda")
    for n_labels, phases in CASES:
        if phases == 2:
            vol = synthetic.make_synthetic_volume(seed=SEED, n_slices=1, shape=(SIZE, SIZE), device=dev)
        else:
            vol = synthetic.make_kary_volume(seed=SEED, n_slices=1, shape=(SIZE, SIZE),
                                             n_phases=phases, device=dev)
        config = api.ExecutionConfig(n_labels=n_labels, overseg_grid=(GRID, GRID), init="quantile")
        plan = api.Segmenter(config, device=dev).plan(vol.images[0])
        if n_labels == 2:
            solve = warm_solve_ops(plan, config)
        args, kw, labels, sctx = state_on_cpu(plan)
        on_card = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
        for precision in ("f32", "bf16"):
            out = ops.fused_em_tick(*on_card, offsets=plan.problem.hoods.offsets,
                                    precision=precision, **kw)
            torch.cuda.synchronize()
            row = {"K": n_labels, "precision": precision, "operands": digest(*args[:12]),
                   **{n: digest(t) for n, t in zip(NAMES, out)}, "outputs": digest(*out)}
            if hasattr(ops, "tick_workspace"):
                ws_out = workspace_bits(plan, on_card, labels, sctx, precision)
                row["workspace_equals_entry"] = digest(*ws_out) == row["outputs"]
            print(json.dumps(row), flush=True)
        if n_labels == 2:
            step = map_step_ms(plan, args, labels, sctx)
    print(json.dumps(step), flush=True)
    print(json.dumps(solve), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
