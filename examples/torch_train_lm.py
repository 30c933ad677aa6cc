"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter LM for a
few hundred steps on the synthetic pipeline, with checkpointing, and a check
that the loss drops.

The counterpart of ``train_lm.py`` on ``repro_torch``: the qwen2 family
architecture scaled to ~100M parameters (width and depth overridden), the
port's train step (AdamW, clipping, the flash kernel in the forward pass on
the card) under its restartable loop (``training.fault.run_training``).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]              # on the card
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu [--steps 300] # plain PyTorch on the host
"""

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.training import data as data_mod
from repro_torch.training.fault import StragglerWatchdog, run_training
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, make_sharded_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~110M params: 12 layers, d_model 640, untied 32k embeddings.
    cfg = dataclasses.replace(
        get_config("qwen2-1.5b"),
        n_layers=12,
        d_model=640,
        n_heads=10,
        n_kv_heads=2,
        head_dim=64,
        d_ff=2560,
        vocab_size=32_768,
        tie_embeddings=False,
        param_dtype="float32",
        compute_dtype="float32",
        logit_chunk=128,
        attn_chunk=128,
        remat_policy="none",
    )
    ts_cfg = TrainStepConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps, use_master_fp32=False)
    )
    state, _ = make_sharded_train_state(cfg, None, ts_cfg, device=device)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"params: {n_params/1e6:.1f}M  device: {device}")

    step_fn = make_train_step(cfg, None, ts_cfg)
    dcfg = data_mod.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)

    def make_batch(i: int):
        return {k: torch.from_numpy(v).to(device) for k, v in data_mod.make_batch(dcfg, i).items()}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        report = run_training(
            step_fn=step_fn,
            state=state,
            make_batch=make_batch,
            num_steps=args.steps,
            ckpt_dir=ckpt_dir,
            ckpt_every=100,
            log_every=20,
            watchdog=StragglerWatchdog(),
        )

    first = float(np.mean(report.losses[:10]))
    last = float(np.mean(report.losses[-10:]))
    print(f"loss: first10={first:.3f} -> last10={last:.3f}")
    assert last < first - 0.5, "loss should drop by >0.5 nats on the copy task"
    print("OK: loss dropped — end-to-end training works.")
    return {"first": first, "last": last, "steps": args.steps}


if __name__ == "__main__":
    main()
