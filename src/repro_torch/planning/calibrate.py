"""``python -m repro_torch.planning.calibrate``: the one-shot
microbenchmark pass that fits the checked-in calibration table on the card
(counterpart of ``repro.planning.calibrate``, on the reference's grid
widened where the card needs it).

The pass times warm session-API calls over a small grid of the execution
axes, each one unmeasured call and then the median of 3, every timed call
ending in ``torch.cuda.synchronize`` (as ``optimize_s`` does):

* **solve grid**: single-lane run-to-convergence ``Segmenter.execute``
  per mode over a size ladder, plus a K ladder, in every mode: fits the
  per-phase transfer/innermost-loops coefficients.  The reference stops
  ``static`` at 192 and ``faithful`` at 96 and runs the K ladder on the
  optimized modes alone; on the card the modes are host-bound (a MAP
  iteration's cost barely grows with capacity), and a fit that stops that
  low extrapolates its capacity terms 2-10x to the 512x512 slice and
  ranked the slice's static solve behind its faithful one, against the
  measurements.  So every mode takes the whole size ladder (to 288, whose
  capacity covers the 512x512 slice's at a 32x32 grid) and the K ladder;
* **batched grid**: lockstep ``submit``/``drain`` at widths 2/4/8 on the
  paper-config slice stack (``configs.pmrf_paper``) at the session's
  default mode: fits the lane-serialization fraction;
* **sharded grid**: the size ladder at each count of ``SHARD_COUNTS`` the
  host can run: 1 in this process, N > 1 as N spawned ranks (NCCL, one
  card each, on the card; gloo on the host).  It fits the
  per-MAP-iteration collective terms; with no N > 1 measured (a one-card
  host) they stay 0, as ``--no-sharded`` leaves them, and
  ``meta.grid.shard_counts`` lists the counts measured.

Raw observations are stored *inside* the table, so the table's bytes are
a pure function of its own contents: ``--refit`` re-runs only the
deterministic fit and must reproduce the file.  Re-measuring (no
``--refit``) gives new timings and new bytes: a deliberate recalibration.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List

from repro_torch.configs import pmrf_paper

from .costmodel import (
    CostModel,
    default_table_path,
    fit_table,
    load_table,
    platform_of,
    table_to_json,
)

#: Square image edge lengths per mode for the solve grid: the reference's
#: ``static-pallas`` ladder, in every mode (module docstring).
SOLVE_SIZES: Dict[str, tuple] = {
    "faithful": (64, 96, 128, 192, 288),
    "static": (64, 96, 128, 192, 288),
    "static-pallas": (64, 96, 128, 192, 288),
}
#: (size, K) points for the K-ary ladder (the reference's), in every mode
#: (module docstring).
K_GRID = ((96, 3), (96, 5))
#: Lockstep widths measured on the paper-config slice stack.
BATCH_WIDTHS = (2, 4, 8)
#: The paper-config stack and its oversegmentation grid.
BATCH_CONFIG = pmrf_paper.CONFIG
BATCH_GRID = (16, 16)
#: Sharded ladder.
SHARD_SIZES = (96, 192, 288)
SHARD_COUNTS = (1, 8)
SHARD_MODE = "static-pallas"   # the serving path's mode


def _grid(size: int) -> tuple:
    return (size // 8, size // 8)


def _round6(x: float) -> float:
    return float(f"{x:.6g}")


def _synced(fn: Callable[[], object], device) -> Callable[[], object]:
    import torch

    def call():
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return out
    return call


def _time(fn: Callable[[], object], repeats: int = 3) -> float:
    """Warm-path median: one unmeasured call, then the median of
    ``repeats`` (the executable cache makes every call a replay)."""
    fn()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return sorted(samples)[len(samples) // 2]


def _image(size: int, k: int, device):
    from repro_torch.core import synthetic

    if k == 2:
        vol = synthetic.make_synthetic_volume(seed=0, n_slices=1, shape=(size, size), device=device)
    else:
        vol = synthetic.make_kary_volume(seed=0, n_slices=1, shape=(size, size), n_phases=k,
                                         device=device)
    return vol.images[0]


def _solve_obs(mode: str, size: int, k: int, *, device, shards: int = 1) -> Dict:
    from repro_torch import api

    sess = api.Segmenter(
        api.ExecutionConfig(overseg_grid=_grid(size), mode=mode, n_labels=k, shards=shards),
        device=device,
    )
    plan = sess.plan(_image(size, k, device))
    sess.compile(plan)   # build the workspace outside the timer
    res = sess.execute(plan, seed=0)
    t = _time(_synced(lambda: sess.execute(plan, seed=0), device))
    cap, nh, nr = plan.bucket
    obs = {
        "kind": "sharded" if shards > 1 else "solve",
        "mode": mode, "cap": cap, "nh": nh, "nr": nr, "k": k,
        "em_iters": int(res.em_iters), "map_iters": int(res.map_iters),
        "seconds": _round6(t),
    }
    if shards > 1:
        obs["shards"] = shards
    return obs


def _batched_obs(width: int, *, device) -> Dict:
    from repro_torch import api
    from repro_torch.core import synthetic

    cfg = BATCH_CONFIG
    vol = synthetic.make_synthetic_volume(
        seed=0, n_slices=max(cfg.synthetic_slices, width), shape=cfg.synthetic_shape,
        gaussian_sigma=cfg.gaussian_sigma, device=device,
    )
    sess = api.Segmenter(api.ExecutionConfig(overseg_grid=BATCH_GRID), device=device)
    plans = [sess.plan(img) for img in vol.images[:width]]
    joint = api.BucketKey(*(max(p.bucket[d] for p in plans) for d in range(3)))

    def run():
        for p in plans:
            sess.submit(p, seed=0, bucket=joint)
        return sess.drain()

    results = run()   # builds the batch-width workspace
    t = _time(_synced(run, device))
    return {
        "kind": "batched", "mode": sess.config.mode,
        "cap": joint.capacity, "nh": joint.n_hoods, "nr": joint.n_regions,
        "k": sess.config.n_labels, "width": width,
        # Every lane runs to the slowest lane's convergence: the max-lane
        # counts are what the lockstep solve runs.
        "em_iters": int(max(r.em_iters for r in results)),
        "map_iters": int(max(r.map_iters for r in results)),
        "seconds": _round6(t),
    }


def _sharded_rank(rank: int, world_size: int, payload: Dict) -> List[Dict]:
    """One rank of the sharded ladder at ``world_size`` shards (spawned by
    :func:`repro_torch.testing.ranks.run_ranks`; rank r on ``cuda:r``)."""
    import torch

    device = torch.device("cuda", rank) if payload["device"] == "cuda" else torch.device("cpu")
    return [_solve_obs(SHARD_MODE, size, 2, device=device, shards=world_size)
            for size in payload["sizes"]]


def _ranks_available(device) -> int:
    """Ranks of one process each the host can run: its cards, or on the
    host's CPU its cores."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def _sharded_obs(*, device) -> List[Dict]:
    """The sharded ladder at each count of ``SHARD_COUNTS`` the host can
    run: 1-shard rows (solve observations) in this process, N > 1 over N
    spawned ranks (rank 0's timings)."""
    import torch

    from repro_torch.testing import ranks

    obs = []
    kind = torch.device(device).type
    for n in SHARD_COUNTS:
        if n == 1:
            obs += [_solve_obs(SHARD_MODE, size, 2, device=device) for size in SHARD_SIZES]
        elif n <= _ranks_available(device):
            with tempfile.TemporaryDirectory() as workdir:
                out = ranks.run_ranks(
                    _sharded_rank, n, workdir, {"device": kind, "sizes": SHARD_SIZES},
                    timeout=3600.0, backend="nccl" if kind == "cuda" else "gloo",
                )
            obs += out[0]
        else:
            continue
        print(f"  sharded ladder at {n} shard(s): {len(SHARD_SIZES)} points", file=sys.stderr)
    return obs


def collect_observations(*, sharded: bool = True, device=None) -> List[Dict]:
    from repro_torch import resolve_device

    device = resolve_device(device)
    obs: List[Dict] = []
    for mode, sizes in SOLVE_SIZES.items():
        for size in sizes:
            obs.append(_solve_obs(mode, size, 2, device=device))
            print(f"  solve {mode} {size}x{size}: {obs[-1]['seconds']}s", file=sys.stderr)
    for size, k in K_GRID:
        for mode in SOLVE_SIZES:
            obs.append(_solve_obs(mode, size, k, device=device))
            print(f"  solve {mode} {size}x{size} K={k}: {obs[-1]['seconds']}s", file=sys.stderr)
    for width in BATCH_WIDTHS:
        obs.append(_batched_obs(width, device=device))
        print(f"  batched width={width}: {obs[-1]['seconds']}s", file=sys.stderr)
    if sharded:
        obs.extend(_sharded_obs(device=device))
    return obs


def card_meta(device) -> Dict:
    """The platform, the card's name and power limit (``nvidia-smi``'s
    line), and the torch and CUDA versions."""
    import torch

    device = torch.device(device)
    meta = {"platform": platform_of(device), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        index = device.index if device.index is not None else torch.cuda.current_device()
        meta["device"] = torch.cuda.get_device_name(index)
        meta["nvidia_smi"] = smi[index] if len(smi) > index else None
    else:
        meta["device"] = "cpu"
    return meta


def table_meta(device, obs: List[Dict], *, sharded: bool) -> Dict:
    measured = sorted({1} | {o["shards"] for o in obs if o["kind"] == "sharded"}) if sharded else []
    return {
        **card_meta(device),
        "source": "calibrate",
        "grid": {
            "solve_sizes": {m: list(s) for m, s in SOLVE_SIZES.items()},
            "k_grid": [list(p) for p in K_GRID],
            "k_grid_modes": list(SOLVE_SIZES),
            "batch_widths": list(BATCH_WIDTHS),
            "shard_sizes": list(SHARD_SIZES),
            "shard_counts": measured,
        },
    }


def refit(path: pathlib.Path) -> str:
    """Deterministic refit from the table's own stored observations
    (byte-identical output for an untampered table)."""
    table = load_table(path)
    return table_to_json(fit_table(table["observations"], table["meta"]))


def _summarize(table: Dict) -> None:
    model = CostModel(table)
    pr = table["priors"]
    print(
        f"fitted: serial_frac={table['width']['serial_frac']} "
        f"iter_cv={pr['iter_cv']} mean_em_iters={pr['mean_em_iters']:.2f} "
        f"sharding={table['sharding']}",
        file=sys.stderr,
    )
    seen = set()
    for o in table["observations"]:
        if o["kind"] != "sharded":
            continue
        bucket = (o["cap"], o["nh"], o["nr"])
        if bucket in seen:
            continue
        seen.add(bucket)
        d = model.choose_shards(mode=o["mode"], bucket=bucket, candidates=SHARD_COUNTS)
        print(f"  bucket {bucket}: choose_shards -> {d.shards} "
              f"{d.as_dict()['predicted_seconds']}", file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.planning.calibrate", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--out", type=pathlib.Path, default=default_table_path(),
        help="table path (default: the checked-in src/repro_torch/planning/calibration.json)",
    )
    ap.add_argument(
        "--refit", action="store_true",
        help="re-fit from the stored observations only (deterministic) instead of re-measuring",
    )
    ap.add_argument(
        "--no-sharded", action="store_true",
        help="skip the sharded pass (the collective terms stay zero)",
    )
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    if args.refit:
        args.out.write_text(refit(args.out))
        print(f"refit from stored observations -> {args.out}", file=sys.stderr)
        return

    from repro_torch import resolve_device

    device = resolve_device(args.device)
    print(f"calibrating on {device} ...", file=sys.stderr)
    obs = collect_observations(sharded=not args.no_sharded, device=device)
    table = fit_table(obs, table_meta(device, obs, sharded=not args.no_sharded))
    args.out.write_text(table_to_json(table))
    print(f"{len(obs)} observations -> {args.out}", file=sys.stderr)
    _summarize(table)


if __name__ == "__main__":
    main()
