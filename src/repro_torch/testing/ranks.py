"""Run a function on several ranks of a process group.

The sharded route's tests hold several CPU ranks against one reference
run, and the calibration's sharded pass times N ranks on N cards.
:func:`run_ranks` starts one ``spawn``ed process per rank; each joins a
gloo group (``backend="nccl"``: an NCCL group, rank r on ``cuda:r``)
through a ``FileStore`` in the caller's directory, calls one of
the module-level functions below with its rank and the caller's payload
(numpy arrays and plain values), and writes what it returns to a pickle.
The caller gets the list of results in rank order, or an error: a rank
that raised (with its traceback), died, or outlived ``timeout`` seconds,
in which case every rank still running is killed.  The functions live in
the package, not in a test file, so that spawned processes can import
them.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np


def run_ranks(fn: Callable, world_size: int, workdir, payload: Any, timeout: float = 120.0,
              backend: str = "gloo") -> List[Any]:
    """``fn(rank, world_size, payload)`` on ``world_size`` spawned ranks."""
    workdir = Path(workdir)
    store = workdir / "filestore"
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=_entry,
            args=(fn, rank, world_size, str(store), payload, str(workdir / f"rank{rank}.pkl"),
                  backend),
            daemon=True,
        )
        for rank in range(world_size)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} still running after {timeout} s")
    results = []
    for rank, p in enumerate(procs):
        out = workdir / f"rank{rank}.pkl"
        if p.exitcode != 0 or not out.exists():
            raise RuntimeError(f"rank {rank} exited with code {p.exitcode} and no result")
        ok, value = pickle.loads(out.read_bytes())
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        results.append(value)
    return results


def _entry(fn, rank, world_size, store_path, payload, out_path, backend) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        try:
            result = (True, fn(rank, world_size, payload))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the caller with its traceback
        result = (False, traceback.format_exc())
    Path(out_path).write_bytes(pickle.dumps(result))


def in_turn(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Several of the functions below on one group, in turn: ``payload``
    maps a key to (function name, its payload); returns their results by
    key."""
    return {key: globals()[name](rank, world_size, part) for key, (name, part) in payload.items()}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def dpp_primitives(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Every ``dpp_sharded`` primitive on this rank's block of the payload's
    global arrays (``values``: (N,) float32, ``ids``: (N,) int32 keys into
    ``num_segments``, ``ints``: (N,) int32, ``flags``: (world_size,) bool,
    one per rank)."""
    import torch

    from repro_torch.core import dpp_sharded as ds

    n = payload["values"].shape[0]
    start, stop = ds.shard_bounds(n, None)
    v = torch.from_numpy(payload["values"][start:stop])
    ids = torch.from_numpy(payload["ids"][start:stop])
    ints = torch.from_numpy(payload["ints"][start:stop])
    segs = payload["num_segments"]
    flags = torch.tensor([bool(payload["flags"][rank])])
    return {
        "bounds": (start, stop),
        "scan": _np(ds.global_scan(v, None)),
        "scan_exclusive": _np(ds.global_scan(v, None, exclusive=True)),
        "scan_ints": _np(ds.global_scan(ints, None)),
        "scan_empty": _np(ds.global_scan(ints[:0] if rank == 0 else ints, None)),
        "sum": float(ds.global_reduce(v, None, "add")),
        "min": float(ds.global_reduce(v, None, "min")),
        "max": float(ds.global_reduce(v, None, "max")),
        "rbk_add": _np(ds.global_reduce_by_key(ids, v, segs, None, "add")),
        "rbk_min": _np(ds.global_reduce_by_key(ids, v, segs, None, "min")),
        "all_converged": bool(ds.global_all_converged(flags, None)),
        "all_true": bool(ds.global_all_converged(torch.tensor([True]), None)),
    }


def sharded_em(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """``run_em_sharded`` over the group on each problem of the payload.

    ``payload["problems"]`` maps a name to ``(problem, jax_parts, config)``:
    a ``convert.problem_from_numpy`` dict, the reference's
    ``partition_hoods`` result for ``world_size`` as a
    ``convert.hoods_from_numpy`` dict, and ``EMConfig`` keywords.  Each
    problem is solved twice, on this package's partition and on the
    reference's.  ``payload["launcher"]``, if present, is an argument list
    for ``launch.segment.main`` run on the same group.  With
    ``payload["mismatch"]``, the last problem is solved once more with
    another ``labels0`` on rank 1, and ``out["mismatch"]`` holds the error
    this rank raised (``None`` if it raised none).
    """
    from repro_torch.core.pmrf import convert
    from repro_torch.core.pmrf import distributed as D
    from repro_torch.core.pmrf import em as em_mod

    def summary(res) -> Dict[str, Any]:
        return {
            "labels": _np(res.labels), "mu": _np(res.mu), "sigma": _np(res.sigma),
            "hood_energy": _np(res.hood_energy), "em_iters": res.em_iters,
            "map_iters": res.map_iters, "status": res.status,
        }

    out: Dict[str, Any] = {}
    for name, (problem, jax_parts, config) in payload["problems"].items():
        prob = convert.problem_from_numpy(problem, device="cpu")
        cfg = em_mod.EMConfig(**config)
        parts = D.partition_hoods(prob.hoods, world_size)
        own = D.run_em_sharded(parts, prob.model, prob.labels0, prob.mu0, prob.sigma0, config=cfg)
        carried = convert.hoods_from_numpy(jax_parts, device="cpu")
        theirs = D.run_em_sharded(carried, prob.model, prob.labels0, prob.mu0, prob.sigma0, config=cfg)
        out[name] = {"own_partition": summary(own), "jax_partition": summary(theirs)}
    if payload.get("mismatch"):
        labels0 = prob.labels0.clone()
        labels0[0] += rank
        try:
            D.run_em_sharded(parts, prob.model, labels0, prob.mu0, prob.sigma0, config=cfg)
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
    if "launcher" in payload:
        from repro_torch.launch import segment

        out["launcher"] = segment.main(payload["launcher"])
    return out


def map_step_counts(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """The sharded MAP step's label counts on this rank's block.

    ``payload["problems"]`` maps a name to ``(problem, labels)``: a
    ``convert.problem_from_numpy`` dict and (V+1,) int32 labels.  For each,
    on the block of ``partition_hoods(hoods, world_size)``: whether every
    valid element's label counts over its hood's whole run
    (``map_step.hood_runs``, what the CUDA step counts) equal the counts the
    old composition gathers for it after an all-reduce
    (``energy.map_step_operands``), whether the runs' block parts hold
    exactly the block's valid elements, and whether one step of the plain
    workspace writes the old composition's kernel outputs (before the
    all-reduce) bit for bit.
    """
    import torch
    import torch.distributed as dist

    from repro_torch.core.pmrf import collectives, convert
    from repro_torch.core.pmrf import distributed as D
    from repro_torch.core.pmrf import energy as E
    from repro_torch.kernels import map_step, ops, ref

    ctx = collectives.ReduceCtx(group=dist.group.WORLD)
    out: Dict[str, Any] = {}
    for name, (problem, labels) in payload["problems"].items():
        prob = convert.problem_from_numpy(problem, device="cpu")
        model = prob.model
        n_labels = model.n_labels
        parts = D.partition_hoods(prob.hoods, world_size)
        ranges, hood_lo, block = map_step.hood_runs(parts, rank, world_size)
        vertex, valid = parts.vertex.numpy(), parts.valid.numpy()
        runs = np.stack([np.bincount(labels[vertex[b:e]][valid[b:e]], minlength=n_labels)
                         for b, e, _, _ in ranges]) if len(ranges) else np.zeros((0, n_labels))
        local = D.shard_block(parts, rank, world_size)
        lab = torch.from_numpy(labels)
        sctx = E.make_static_context(local, model, ctx=ctx)
        args, kw = E.map_step_operands(local, model, sctx, lab, prob.mu0, prob.sigma0, ctx=ctx)
        cnt_e = _np(args[2]).T
        lv = _np(local.valid)
        hid = _np(local.hood_id)[lv].astype(np.int64)
        at = np.nonzero(lv)[0] + rank * block
        j = hid - hood_lo
        in_range = bool(np.all((j >= 0) & (j < len(ranges))))
        covered = in_range and bool(np.all((ranges[j, 2] <= at) & (at < ranges[j, 3])))
        counts_equal = in_range and np.array_equal(runs[j].astype(np.float32), cnt_e[lv])
        ws = ops.map_step_workspace(parts, model, rank=rank, n_shards=world_size)
        ws.start(sctx.y, sctx.w, sctx.nall_e, sctx.validf, lab)
        ws.begin_em(prob.mu0, torch.maximum(prob.sigma0, model.sigma_min))
        ws.step(False)
        _, _, hood_e, votes = ref.fused_map_step(*args, **kw)
        step_equal = (torch.equal(ws.buffer[: ws.n_hoods].view(torch.int32), hood_e.view(torch.int32))
                      and torch.equal(ws.buffer[ws.n_hoods:], votes.reshape(-1)))
        out[name] = {"n_local": len(ranges), "valid_in_block": int(lv.sum()),
                     "counts_equal": counts_equal, "covered": covered, "step_equal": step_equal,
                     "plain_workspace": isinstance(ws, ref.PlainMapStepWorkspace)}
    return out


# ---------------------------------------------------------------------------
# the parallel/ slice: a DeviceMesh over the group
# ---------------------------------------------------------------------------


def _rank_device() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _cfg(arch: str, overrides: Dict[str, Any], reduced: bool = True):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg.reduced() if reduced else cfg, **overrides)


def _tensors(tree, device: str, grad: bool = False):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v, device, grad) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(device).requires_grad_(grad)


def parallel_model(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """The model-side pieces of ``parallel/`` on a ``("model",)`` mesh of
    every rank.

    * ``payload["gqa"]`` / ``["mla"]``: sequence-parallel decode.  Keys
      ``arch``, ``overrides`` (config fields), ``params`` (the attention
      block's arrays), ``x`` (B, 1, D), the whole caches (``k``/``v`` or
      ``ckv``/``krope``) and ``ts``: for each t, ``gqa_decode`` /
      ``mla_decode`` with a runtime whose ``seq_axis`` is ``model``, on
      this rank's sequence slice of fresh caches.  Returns per t the
      output and this rank's cache slices.
    * ``payload["ep"]``: per name (``arch``, ``overrides``, ``params``:
      the MoE block's arrays with the whole expert stacks, ``x`` (B, S, D)
      and ``w``, the weights of the scalar loss ``sum(y * w)``):
      ``moe_ffn(axis=model group)`` on this rank's experts; returns y and
      the gradients of x, the router, this rank's expert blocks and the
      shared experts.
    * ``payload["int8"]``: ``g`` (world_size, N) float32, one row per rank,
      and ``seeds``: ``int8_stochastic_allreduce`` over the group per seed
      (the generator seeded by seed * world_size + rank); returns every
      result.
    * the mesh layout: ``make_mesh`` of (world_size // 2, 2) named
      (data, model) gives each rank its row-major coordinates, and the
      production mesh and a mesh of the wrong size raise.
    """
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import ParallelRuntime
    from repro_torch.training import compression

    dev = _rank_device()
    mesh = mesh_mod.make_mesh((world_size,), ("model",))
    rt = ParallelRuntime(mesh=mesh, tp_axis="model", seq_axis="model")
    out: Dict[str, Any] = {"model_rank": mesh.get_local_rank("model")}
    with torch.no_grad():
        for kind in ("gqa", "mla"):
            if kind not in payload:
                continue
            spec = payload[kind]
            cfg = _cfg(spec["arch"], spec["overrides"])
            p = _tensors(spec["params"], dev)
            x = _tensors(spec["x"], dev)
            rows = {}
            for t in spec["ts"]:
                if kind == "gqa":
                    s_loc = spec["k"].shape[2] // world_size
                    kc = _tensors(spec["k"][:, :, rank * s_loc:(rank + 1) * s_loc], dev).clone()
                    vc = _tensors(spec["v"][:, :, rank * s_loc:(rank + 1) * s_loc], dev).clone()
                    y, kc, vc = A.gqa_decode(p, x, cfg, kc, vc, t, rt=rt)
                else:
                    s_loc = spec["ckv"].shape[1] // world_size
                    kc = _tensors(spec["ckv"][:, rank * s_loc:(rank + 1) * s_loc], dev).clone()
                    vc = _tensors(spec["krope"][:, :, rank * s_loc:(rank + 1) * s_loc], dev).clone()
                    y, kc, vc = A.mla_decode(p, x, cfg, kc, vc, t, rt=rt)
                rows[t] = {"y": _np(y), "c0": _np(kc), "c1": _np(vc)}
            out[kind] = rows

    out["ep"] = {}
    for name, spec in payload.get("ep", {}).items():
        cfg = _cfg(spec["arch"], spec["overrides"])
        e_loc = cfg.moe_num_experts // world_size
        params = dict(spec["params"])
        for w in ("w_gate", "w_up", "w_down"):
            params[w] = params[w][rank * e_loc:(rank + 1) * e_loc]
        p = _tensors(params, dev, grad=True)
        x = _tensors(spec["x"], dev, grad=True)
        y = M.moe_ffn(p, x, cfg, axis=mesh.get_group("model"))
        torch.sum(y * _tensors(spec["w"], dev)).backward()
        grads = {k: _np(t.grad) for k, t in p.items() if not isinstance(t, dict)}
        grads.update({f"shared/{k}": _np(t.grad) for k, t in p.get("shared", {}).items()})
        out["ep"][name] = {"y": _np(y), "dx": _np(x.grad), "grads": grads}

    if "int8" in payload:
        g = {"g": torch.from_numpy(payload["int8"]["g"][rank]).to(dev)}
        results = []
        for seed in payload["int8"]["seeds"]:
            gen = torch.Generator(device=dev).manual_seed(seed * world_size + rank)
            results.append(_np(compression.int8_stochastic_allreduce(g, dist.group.WORLD, gen)["g"]))
        out["int8"] = np.stack(results)

    grid = mesh_mod.make_mesh((world_size // 2, 2), ("data", "model"))
    out["grid"] = (grid.get_local_rank("data"), grid.get_local_rank("model"))
    out["raises"] = []
    for make in (lambda: mesh_mod.make_production_mesh(), lambda: mesh_mod.make_mesh((world_size + 1,), ("data",))):
        try:
            make()
            out["raises"].append(None)
        except ValueError as e:
            out["raises"].append(str(e))
    return out


def parallel_train(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """The sharded train step and its checkpoints on meshes of every rank.

    ``payload["runs"]``: a list of dicts with ``name``, ``arch``,
    ``overrides``, ``mesh`` ((shape, axes)), ``codec``, ``optimizer``
    (``AdamWConfig`` fields), ``seed``, ``batches`` (numpy batch dicts),
    and optionally ``save`` (a directory: the state after the steps is
    saved there with its specs) or ``restore`` (a directory: instead of
    stepping, the newest save there is restored into a state built from
    ``seed``).  Returns per run its losses and grad norms, and from rank
    0 the state's leaves (``checkpoint.state_leaves``, gathered whole)
    and the ``state_specs`` spec strings."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.training import checkpoint as CK
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig, make_sharded_train_state, make_train_step

    dev = _rank_device()
    out: Dict[str, Any] = {}
    for run in payload["runs"]:
        cfg = _cfg(run["arch"], run["overrides"], run.get("reduced", True))
        mesh = mesh_mod.make_mesh(*run["mesh"])
        ts = TrainStepConfig(optimizer=AdamWConfig(**run["optimizer"]), grad_codec=run["codec"], seed=run["seed"])
        state, specs = make_sharded_train_state(cfg, mesh, ts, device=dev)
        losses, norms = [], []
        if "restore" in run:
            _, state, _ = CK.restore_checkpoint(run["restore"], state)
        else:
            step = make_train_step(cfg, mesh, ts)
            for b in run["batches"]:
                state, metrics = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        if "save" in run:
            CK.save_checkpoint(run["save"], len(run["batches"]), state, specs=specs, mesh=mesh)
        leaves = CK.state_leaves(state)
        out[run["name"]] = {"losses": losses, "grad_norms": norms, "step": int(state["opt"].step)}
        if rank == 0:
            out[run["name"]]["leaves"] = {n: CK._to_numpy(t)[0] for n, t in leaves}
            out[run["name"]]["spec_strings"] = CK.spec_strings(specs)
    return out


def parallel_card(rank: int, world_size: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    """``testing.parallel_checks`` on every rank of a several-card NCCL
    group: ``train_pair`` (``payload["train"]``: ``arch``, ``n_layers``,
    ``batch``, ``seq``, ``steps``, ``optimizer``) on a ``("data",)`` mesh
    of every rank; ``ep_check`` (``payload["ep"]``: ``arch``,
    ``n_layers``, ``batch``, ``seq``) and ``sp_check``
    (``payload["sp"]``: ``batch``, ``max_seq``, ``t``) on a ``("model",)``
    mesh of every rank.  Each rank computes its own single-device side.
    ``payload["reduced"]`` takes the configs' reduced variants (a CPU
    rehearsal)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.testing import parallel_checks as PC
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig

    def config(arch: str, **kw):
        cfg = get_config(arch)
        return dataclasses.replace(cfg.reduced() if payload.get("reduced") else cfg, **kw)

    dev = _rank_device()
    out: Dict[str, Any] = {}
    tr = payload["train"]
    cfg = config(tr["arch"], n_layers=tr["n_layers"])
    ts = TrainStepConfig(optimizer=AdamWConfig(**tr["optimizer"]))
    out["train"] = PC.train_pair(cfg, mesh_mod.make_mesh((world_size,), ("data",)), ts,
                                 PC.batches(cfg, tr["batch"], tr["seq"], tr["steps"], dev), dev)
    model_mesh = mesh_mod.make_mesh((world_size,), ("model",))
    ep = payload["ep"]
    cfg = config(ep["arch"], n_layers=ep["n_layers"])
    out["ep"] = PC.ep_check(cfg, model_mesh, dev, PC.batches(cfg, ep["batch"], ep["seq"], 1, dev)[0])
    sp = payload["sp"]
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    out["sp"] = PC.sp_check(config("qwen2-1.5b", **f32), config("deepseek-v2-lite-16b", **f32), model_mesh, dev,
                            batch=sp["batch"], max_seq=sp["max_seq"], t=sp["t"])
    return out
