"""Checks of the ``parallel/`` slice on a mesh of cards: the sharded train
step against the single-device step, expert parallelism and
sequence-parallel decode against their single-device paths.

``chip_smoke.py``'s ``parallel`` phase runs them on a one-rank NCCL mesh
(where every collective is a copy, so the results are bit for bit), and
``testing.ranks.parallel_card`` on every rank of a several-card group.
Each returns plain numbers and raises nothing of its own: the caller
holds them to its bounds.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

Tensor = torch.Tensor


def batches(cfg, batch: int, seq: int, n: int, device, seed: int = 0) -> List[Dict[str, Tensor]]:
    """``n`` batches of the training data pipeline, on ``device``."""
    from repro_torch.training import data as data_mod

    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)
    return [{k: torch.from_numpy(v).to(device) for k, v in data_mod.make_batch(dcfg, i).items()} for i in range(n)]


def train_run(cfg, mesh, ts_cfg, batch_list: List[Dict[str, Tensor]], device) -> Dict[str, Any]:
    """``make_sharded_train_state`` and one ``make_train_step`` step per
    batch, on ``mesh`` (None: one device): the losses, grad norms, ms per
    step (host clock to the loss read, which waits for the step), the
    final state and its specs."""
    from repro_torch.training.train_step import make_sharded_train_state, make_train_step

    state, specs = make_sharded_train_state(cfg, mesh, ts_cfg, device=device)
    step = make_train_step(cfg, mesh, ts_cfg)
    losses, norms, step_ms = [], [], []
    for b in batch_list:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms, "state": state, "specs": specs}


def param_blocks(state) -> Dict[str, Tensor]:
    """The state's parameters by name: a ``ShardedParams``'s blocks, or the
    model's parameters."""
    from repro_torch.parallel.sharding import ShardedParams

    params = state["params"]
    return dict(params.blocks) if isinstance(params, ShardedParams) else dict(params.named_parameters())


def _loss_and_grads(api, model, batch, cfg, rt) -> tuple:
    for p in model.parameters():
        p.grad = None
    loss = api.loss(model, batch, cfg, rt)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def ep_check(cfg, mesh, device, batch: Dict[str, Tensor], seed: int = 0) -> Dict[str, Any]:
    """The loss and every gradient of ``cfg``'s model (seeded init) through
    the expert-parallel branch on ``mesh`` (this rank's experts) against
    the model without a mesh (every expert): whether each is equal bit
    for bit, and the largest differences (the expert stacks' gradients
    against this rank's block of the single-device ones)."""
    from repro_torch.models.registry import get_api
    from repro_torch.parallel import sharding as SH
    from repro_torch.training.train_step import make_runtime

    api = get_api(cfg)
    model = api.init(torch.Generator(device=device).manual_seed(seed), cfg).requires_grad_(True)
    loss0, want = _loss_and_grads(api, model, batch, cfg, None)
    specs = SH.module_specs(model, mesh)
    computed = SH.cut_computed(model, mesh, specs)
    want = {n: SH.local_slice(g, specs[n], mesh, axes=computed[n]) if computed[n] else g for n, g in want.items()}
    loss1, got = _loss_and_grads(api, model, batch, cfg, make_runtime(mesh))
    diffs = {n: float((got[n].float() - want[n].float()).abs().max()) for n in want}
    worst = max(diffs, key=diffs.get)
    return {"loss": float(loss0), "loss_ep": float(loss1), "loss_bit_equal": bool(torch.equal(loss0, loss1)),
            "grads": len(want), "grads_bit_equal": sum(torch.equal(got[n], want[n]) for n in want),
            "expert_leaves_cut": sum(bool(c) for c in computed.values()),
            "max_abs_grad_diff": diffs[worst], "worst_grad": worst}


def sp_check(gqa_cfg, mla_cfg, mesh, device, *, batch: int, max_seq: int, t: int, seed: int = 0) -> Dict[str, Any]:
    """``gqa_decode`` and ``mla_decode`` on this rank's slice of a
    sequence-split cache (a runtime whose ``seq_axis`` is ``model``)
    against the same calls on the whole cache: the outputs' largest
    difference, and the caches' (this rank's slice of the whole one's)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import ParallelRuntime
    from repro_torch.parallel.sharding import axis_sizes

    rt = ParallelRuntime(mesh=mesh, tp_axis="model", seq_axis="model")
    n = axis_sizes(mesh)["model"]
    lo = mesh.get_local_rank("model") * (max_seq // n)
    hi = lo + max_seq // n
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, Any] = {}
    with torch.no_grad():
        for kind, cfg in (("gqa", gqa_cfg), ("mla", mla_cfg)):
            dtype = L.dtype_of(cfg.param_dtype)
            randn = lambda *shape: torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)
            x = randn(batch, 1, cfg.d_model)
            if kind == "gqa":
                p = A.gqa_init(gen, cfg, dtype)
                c0 = randn(batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
                c1 = randn(batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
                cut = (lambda c: c[:, :, lo:hi], lambda c: c[:, :, lo:hi])
                decode = A.gqa_decode
            else:
                p = A.mla_init(gen, cfg, dtype)
                c0 = randn(batch, max_seq, cfg.mla_kv_lora_rank)
                c1 = randn(batch, 1, max_seq, cfg.mla_rope_head_dim)
                cut = (lambda c: c[:, lo:hi], lambda c: c[:, :, lo:hi])
                decode = A.mla_decode
            want, w0, w1 = decode(p, x, cfg, c0.clone(), c1.clone(), t)
            got, g0, g1 = decode(p, x, cfg, cut[0](c0).clone(), cut[1](c1).clone(), t, rt=rt)
            out[kind] = {"max_abs_err": float((got.float() - want.float()).abs().max()),
                         "max_abs_out": float(want.float().abs().max()),
                         "cache_max_abs_err": max(float((g0 - cut[0](w0)).abs().max()),
                                                  float((g1 - cut[1](w1)).abs().max())),
                         "shape": list(got.shape)}
    return out


def rel_diff(a: List[float], b: List[float]) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def train_pair(cfg, mesh, ts_cfg, batch_list, device) -> Dict[str, Any]:
    """The same steps on one device and on ``mesh``: losses and grad norms
    of both, their largest relative differences, and the largest
    difference of the final parameters (each rank's block against its
    slice of the single-device ones)."""
    from repro_torch.parallel import sharding as SH

    single = train_run(cfg, None, ts_cfg, batch_list, device)
    whole = {n: p.detach().clone() for n, p in param_blocks(single["state"]).items()}
    del single["state"]
    meshed = train_run(cfg, mesh, ts_cfg, batch_list, device)
    sp = meshed["state"]["params"]
    diff = max(float((b.float() - SH.local_slice(whole[n], sp.specs[n], mesh).float()).abs().max())
               for n, b in sp.blocks.items())
    return {"single": {k: single[k] for k in ("losses", "grad_norms", "step_ms")},
            "mesh": {k: meshed[k] for k in ("losses", "grad_norms", "step_ms")},
            "loss_rel_diff": rel_diff(meshed["losses"], single["losses"]),
            "grad_norm_rel_diff": rel_diff(meshed["grad_norms"], single["grad_norms"]),
            "param_max_abs_diff": diff}
