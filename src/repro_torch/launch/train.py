"""End-to-end training launcher.

Counterpart of ``repro.launch.train``, with the same flags and final JSON
line plus ``--device`` (default: the card, and without one it raises;
``--device cpu`` runs the plain PyTorch path on the host).  Runs real
steps with checkpoint/restart, the straggler watchdog, the preemption
save and the synthetic data pipeline.  The reduced config is the
default; ``--full`` trains the published one.  As in the reference, an
``encdec`` batch carries zero frames and a ``vlm`` batch zero patch
embeddings.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --full \\
        --steps 8 --batch 8 --seq 512          # on the card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.training import data as data_mod
from repro_torch.training.fault import PreemptionHandler, StragglerWatchdog, run_training
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, make_sharded_train_state, make_train_step


def build(arch: str, *, reduced: bool, batch: int, seq: int,
          microbatches: int = 1, lr: float = 3e-4, steps: int = 100,
          d_model: Optional[int] = None, n_layers: Optional[int] = None,
          seed: int = 0, device: DeviceLike = None, backend: Optional[str] = None, **overrides):
    """(cfg, state, step_fn, make_batch) for ``arch``, as the reference's
    ``build``, on ``device``.  ``overrides`` are further ``ModelConfig``
    fields (e.g. ``param_dtype``); ``backend`` is the attention route."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if d_model:
        overrides["d_model"] = d_model
        overrides["head_dim"] = d_model // max(cfg.n_heads, 1) if cfg.n_heads else 0
    if n_layers:
        overrides["n_layers"] = n_layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if seq % cfg.logit_chunk and seq >= cfg.logit_chunk:
        raise ValueError(f"--seq {seq} is not a multiple of the logit chunk {cfg.logit_chunk}")
    if seq < cfg.logit_chunk:
        cfg = dataclasses.replace(cfg, logit_chunk=seq)

    ts_cfg = TrainStepConfig(
        optimizer=AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1), total_steps=steps),
        microbatches=microbatches,
        seed=seed,
    )
    state, _ = make_sharded_train_state(cfg, None, ts_cfg, device=device)
    step_fn = make_train_step(cfg, None, ts_cfg, backend=backend)
    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)

    def make_batch(i: int):
        out = {k: torch.from_numpy(v).to(device) for k, v in data_mod.make_batch(dcfg, i).items()}
        if cfg.family == "encdec":
            out["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32, device=device)
        if cfg.family == "vlm":
            out["vision_embeds"] = torch.zeros((batch, cfg.vision_patches, cfg.d_model), dtype=torch.float32,
                                               device=device)
        return out

    return cfg, state, step_fn, make_batch


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)

    cfg, state, step_fn, make_batch = build(
        args.arch, reduced=not args.full, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, lr=args.lr, steps=args.steps,
        d_model=args.d_model, n_layers=args.n_layers, seed=args.seed, device=args.device,
    )
    n_params = sum(p.numel() for p in state["params"].parameters())
    device = next(state["params"].parameters()).device
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    preemption = PreemptionHandler(install=True)
    try:
        report = run_training(
            step_fn=step_fn,
            state=state,
            make_batch=make_batch,
            num_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            watchdog=StragglerWatchdog(),
            preemption=preemption,
        )
    finally:
        preemption.restore()
    first = float(np.mean(report.losses[:5])) if report.losses else float("nan")
    last = float(np.mean(report.losses[-5:])) if report.losses else float("nan")
    out = {
        "last_step": report.last_step,
        "loss_first5_mean": round(first, 4),
        "loss_last5_mean": round(last, 4),
        "stragglers": len(report.straggler_events),
        "preempted": report.preempted,
        "resumed_from": report.resumed_from,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
