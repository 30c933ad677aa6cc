"""Run a function on several CPU ranks of a gloo process group.

The sharded route's tests hold several ranks against one reference run.
:func:`run_ranks` starts one ``spawn``ed process per rank; each joins a
gloo group through a ``FileStore`` in the caller's directory, calls one of
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


def run_ranks(fn: Callable, world_size: int, workdir, payload: Any, timeout: float = 120.0) -> List[Any]:
    """``fn(rank, world_size, payload)`` on ``world_size`` spawned ranks."""
    workdir = Path(workdir)
    store = workdir / "filestore"
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(
            target=_entry,
            args=(fn, rank, world_size, str(store), payload, str(workdir / f"rank{rank}.pkl")),
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


def _entry(fn, rank, world_size, store_path, payload, out_path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world_size)
        try:
            result = (True, fn(rank, world_size, payload))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the caller with its traceback
        result = (False, traceback.format_exc())
    Path(out_path).write_bytes(pickle.dumps(result))


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
