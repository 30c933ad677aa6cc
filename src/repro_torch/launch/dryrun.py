"""Multi-pod dry run: every (architecture x input-shape) cell's step for
one rank of the production mesh, counted from shapes alone, on the host.

Counterpart of ``repro.launch.dryrun``.  The reference forces 512 XLA host
devices, lowers and compiles each cell's jit'd step and reads
``memory_analysis``, ``cost_analysis`` and the HLO text.  PyTorch has none
of those, so here the port's own step runs for rank 0 of a mesh of ranks
that do not exist, on tensors that hold no memory:

* the process group is PyTorch's ``fake`` backend (``FakeStore``, from
  ``torch.testing._internal.distributed.fake_pg``: an internal module of
  torch, imported here and nowhere else) at 256 or 512 ranks, and the
  mesh is ``launch.mesh``'s production shape on ``device_type="cpu"``;
  its collectives return at once, without data;
* the state and inputs are built by ``launch.specs.build_step`` under a
  ``FakeTensorMode`` and the step runs there under ``launch.op_cost``'s
  mode, which counts flops, bytes, collectives and the live-storage peak.

Each cell's record keeps the reference's keys.  ``lower_s`` is the time
to build the step's state and inputs, ``compile_s`` the counted run's
(the port compiles nothing); ``memory`` comes from the live-storage tally
(``argument_bytes`` the state and inputs, ``temp_bytes`` the peak above
them, ``peak_bytes_estimate`` with the plain attention's internals that
the flash kernel keeps on chip left out, ``peak_bytes_plain`` with them);
``cost_analysis_raw`` holds the same loop-aware totals, since nothing
here counts a loop once.  ``roofline`` is ``launch.roofline`` under the
H100's figures: CPU shape arithmetic, not a measurement of a card.  The
model axis gathers dense weights whole (ZeRO-3, ``parallel.sharding``),
so its ranks compute the same rows; ``roofline.useful_flops_ratio``
shows that as it is.

Records go to ``build/dryrun/`` (git-ignored), one JSON file per cell.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_mesh
from repro_torch.launch.roofline import Roofline, analytic_flash_traffic, model_flops_for
from repro_torch.launch.specs import build_step, runnable_cells

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def artifact_path(arch: str, shape: str, multi_pod: bool, variant: str = "") -> Path:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    sub = ARTIFACT_DIR if not variant else ARTIFACT_DIR.parent / f"dryrun_{variant}"
    return sub / f"{arch}__{shape}__{mesh_tag}.json"


def _apply_overrides(cfg, overrides: dict):
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, **overrides)


def start_fake_group(world_size: int) -> None:
    """The default process group as ``world_size`` fake ranks, this process
    rank 0 (an existing group of another size is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size, on the CPU."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for d in shape:
        n *= d
    start_fake_group(n)
    return make_mesh(shape, axes, device_type="cpu")


def _storages(tree) -> Dict[int, int]:
    """Bytes of each storage the tree's tensors hold, by storage."""
    return {t.untyped_storage()._cdata: int(t.untyped_storage().nbytes()) for t in op_cost.state_tensors(tree)}


def cost_cell(cfg, shape: ShapeSpec, mesh=None, *, microbatches: int = 1) -> dict:
    """One cell's step for this rank of ``mesh`` (None: one device), built
    and run under ``FakeTensorMode`` and counted: the record's fields
    without its identity (arch, shape, mesh, status)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.training.train_step import TrainStepConfig

    mesh_shape: Dict[str, int] = ({a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}
                                  if mesh is not None else {})
    n_chips = int(mesh.mesh.numel()) if mesh is not None else 1
    t0 = time.perf_counter()
    with FakeTensorMode():
        cell = build_step(cfg, shape, mesh, ts_cfg=TrainStepConfig(microbatches=microbatches))
        t_lower = time.perf_counter() - t0
        args = _storages(cell.args)
        out, totals = op_cost.count(cell.fn, *cell.args, mesh=mesh)
        t_compile = time.perf_counter() - t0 - t_lower
        outs = _storages(out)
    del out, cell
    argument_bytes = sum(args.values())

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    rf = Roofline(
        flops_per_chip=totals.flops,
        hbm_bytes_per_chip=totals.hbm_bytes,
        coll_bytes_per_chip=totals.coll_total_bytes,
        n_chips=n_chips,
        model_flops=model_flops_for(shape.kind, cfg.n_params(), cfg.active_params(), tokens),
        flash_bytes_per_chip=totals.flash_bytes,
        kernel_flash_bytes=analytic_flash_traffic(cfg, shape, mesh_shape, shape.kind),
        coll_bytes_by_axis=dict(totals.coll_bytes_by_axis),
        mesh_shape=mesh_shape,
    )
    top_dots = sorted(totals.dot_flops_by_shape.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kind": shape.kind,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.active_params(),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": sum(outs.values()),
            "temp_bytes": totals.peak_bytes_estimate - argument_bytes,
            "alias_bytes": sum(n for k, n in outs.items() if k in args),
            "peak_bytes_estimate": totals.peak_bytes_estimate,
            "peak_bytes_plain": totals.peak_bytes,
        },
        "collectives": {
            "bytes_by_op": dict(totals.coll_bytes),
            "count_by_op": dict(totals.coll_count),
            "total_bytes": totals.coll_total_bytes,
            "bytes_by_axis": dict(totals.coll_bytes_by_axis),
        },
        "cost_analysis_raw": {"flops": totals.flops, "bytes_accessed": totals.hbm_bytes},
        "dot_flops": totals.dot_flops,
        "non_attention_dot_flops": totals.non_attention_dot_flops,
        "kernel_bytes": totals.kernel_bytes,
        "ops": totals.ops,
        "top_dots": [{"shape": k, "flops": v} for k, v in top_dots],
        "roofline": rf.as_dict(),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, force: bool = False,
             variant: str = "", overrides: Optional[dict] = None,
             microbatches: int = 1) -> dict:
    cfg = _apply_overrides(get_config(arch), overrides or {})
    out_path = artifact_path(arch, shape_name, multi_pod, variant)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if shape_name in cfg.skip_shapes:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skip(full-attn)"}
    else:
        mesh = production_mesh(multi_pod)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
               **cost_cell(cfg, SHAPES[shape_name], mesh, microbatches=microbatches)}
        rec = {k: rec[k] for k in ("arch", "shape", "mesh", "kind", "status")} | rec
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), help="one architecture")
    ap.add_argument("--shape", choices=sorted(SHAPES), help="one shape")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute records")
    ap.add_argument("--variant", default="", help="record-dir tag for config variants")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument(
        "--set", action="append", default=[], metavar="FIELD=VALUE",
        help="ModelConfig override, e.g. --set remat_policy=dots_nb",
    )
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    if args.all:
        cells = [(arch, shape) for arch in sorted(ARCHS) for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    torch.set_num_threads(1)
    failures = []
    for multi_pod in meshes:
        for arch, shape in cells:
            tag = f"{arch} x {shape} x {'2x16x16' if multi_pod else '16x16'}"
            try:
                rec = run_cell(arch, shape, multi_pod=multi_pod, force=args.force, variant=args.variant,
                               overrides=overrides, microbatches=args.microbatches)
            except Exception as e:  # a failure here is a fault of the port's step on a mesh
                failures.append(tag)
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                continue
            if rec["status"].startswith("skip"):
                print(f"[skip] {tag}: {rec['status']}", flush=True)
                continue
            r = rec["roofline"]
            print(
                f"[ ok ] {tag}: kind={rec['kind']} "
                f"build={rec['lower_s']:.1f}s run={rec['compile_s']:.1f}s "
                f"compute={r['compute_s']*1e3:.2f}ms "
                f"memory={r['memory_s']*1e3:.2f}ms "
                f"collective={r['collective_s']*1e3:.2f}ms "
                f"bound={r['bound']} useful={r['useful_flops_ratio']:.4f} "
                f"peak={rec['memory']['peak_bytes_estimate']/2**30:.2f}GiB/chip",
                flush=True,
            )
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("dry-run complete.")


if __name__ == "__main__":
    main()
