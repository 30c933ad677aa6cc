"""Batched LM serving on the PyTorch/CUDA port: the continuous-batching
engine over a reduced qwen2 config.

The counterpart of ``serve_lm.py`` on ``repro_torch``: submits a mixed
stream of requests, drives the engine, and prints each completion and the
throughput, with the DPP-based top-k sampler (the paper's SortByKey
primitive inside the LM stack).  Prefill attention runs on the flash
kernel on the card.  Weights are random, from the seed.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py              # on the card
      PYTHONPATH=src python examples/torch_serve_lm.py --device cpu # plain PyTorch on the host
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.registry import get_api
from repro_torch.serving import Request, SamplerConfig, ServingEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: the CUDA device (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen2-1.5b").reduced()
    params = get_api(cfg).init(torch.Generator(device=device).manual_seed(0), cfg)
    engine = ServingEngine(
        cfg,
        params,
        max_batch=4,
        max_seq=96,
        sampler=SamplerConfig(temperature=0.8, top_k=40),
        seed=0,
        device=device,
    )

    rng = np.random.default_rng(0)
    # a wave of equal-length prompts batches together; a longer prompt
    # joins once lengths align (continuous admission)
    for rid in range(6):
        engine.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, size=12).astype(np.int32),
                              max_new_tokens=16))
    engine.submit(Request(rid=99, prompt=rng.integers(0, cfg.vocab_size, size=24).astype(np.int32),
                          max_new_tokens=8))

    t0 = time.perf_counter()
    completions = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    for c in sorted(completions, key=lambda c: c.rid):
        print(f"rid={c.rid:3d} prompt_len={c.prompt_len:3d} "
              f"generated={len(c.tokens):3d} finish={c.finish_reason} "
              f"tokens={c.tokens[:8].tolist()}...")
    total = sum(len(c.tokens) for c in completions)
    print(f"{len(completions)} completions, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, {engine.ticks} engine ticks) on {device}")
    assert len(completions) == 7
    return completions


if __name__ == "__main__":
    main()
