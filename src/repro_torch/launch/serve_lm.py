"""LM serving driver: bring up the batched generation engine on a reduced
config and drive a synthetic request stream through it (batched
prefill+decode with continuous admission), reporting latency/throughput.

Counterpart of ``repro.launch.serve_lm``, with the same flags and JSON
line plus ``--device`` (default: the card; ``--device cpu`` runs the plain
PyTorch path on the host).  Like the reference it serves
``get_config(arch).reduced()``; weights are random, from ``--seed``.

Every architecture of the dense, moe and mla_moe families is served
(``--arch qwen3-moe-235b-a22b``, ``--arch deepseek-v2-lite-16b``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-1.5b \\
        --requests 12 --prompt-len 16 --max-new 24 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.registry import get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    api = get_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, cfg)
    engine = ServingEngine(
        cfg,
        params,
        max_batch=args.max_batch,
        max_seq=args.max_seq,
        sampler=SamplerConfig(temperature=args.temperature, top_k=args.top_k),
        seed=args.seed,
        device=device,
    )

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    completions = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in completions)
    out = {
        "arch": cfg.name,
        "completed": len(completions),
        "generated_tokens": toks,
        "wall_s": round(dt, 3),
        "tok_per_s": round(toks / dt, 1),
        "ticks": engine.ticks,
        "mean_latency_s": round(float(np.mean([c.latency_s for c in completions])), 3),
        "device": str(device),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
