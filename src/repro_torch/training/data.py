"""Deterministic, shardable synthetic-token data pipeline.

Real fleets stream tokenized shards from object storage; this container has
no corpus, so the pipeline synthesizes a *reproducible* token stream with
non-trivial statistics (a mixture of Zipfian unigrams and copy/induction
spans so a ~100M model's loss visibly drops within a few hundred steps —
``examples/train_lm.py``).

Properties shared with a production loader:

* **stateless addressing** — batch ``i`` is a pure function of (seed, i),
  so restart-from-checkpoint resumes the stream exactly (no iterator state
  in the checkpoint beyond the step counter);
* **host sharding** — ``host_batch(...)`` slices the global batch by
  (host_index, host_count), the multi-host layout where each host feeds
  its local devices;
* **device placement** — batches are built in numpy and moved to the
  device by the caller (``launch.train``).

Counterpart of ``repro.training.data``, a copy of it (numpy only): the
same (seed, step, host) gives the same batch, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    copy_frac: float = 0.5       # fraction of positions inside copy spans
    span: int = 16               # copy-span length


def _rng_for(cfg: DataConfig, step: int, host_index: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_index])
    )


def _zipf_tokens(rng: np.random.Generator, cfg: DataConfig, shape) -> np.ndarray:
    # Bounded Zipf via inverse-CDF on a truncated harmonic distribution.
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-cfg.zipf_a)
    probs /= probs.sum()
    return rng.choice(cfg.vocab_size, size=shape, p=probs).astype(np.int32)


def make_batch(
    cfg: DataConfig, step: int, *, host_index: int = 0, host_count: int = 1
) -> Dict[str, np.ndarray]:
    """Batch for ``step`` (this host's slice): tokens/labels/mask."""
    assert cfg.global_batch % host_count == 0
    b = cfg.global_batch // host_count
    s = cfg.seq_len
    rng = _rng_for(cfg, step, host_index)

    tokens = _zipf_tokens(rng, cfg, (b, s + 1))

    # Copy/induction spans: pick span starts, copy the preceding span.
    # (needs room for a source and a destination span)
    n_spans = int(cfg.copy_frac * s / cfg.span) if s > 2 * cfg.span else 0
    for _ in range(n_spans):
        start = int(rng.integers(cfg.span, s - cfg.span))
        tokens[:, start : start + cfg.span] = tokens[
            :, start - cfg.span : start
        ]

    return {
        "tokens": tokens[:, :-1],
        "labels": tokens[:, 1:].astype(np.int32),
        "mask": np.ones((b, s), np.float32),
    }


def stream(
    cfg: DataConfig, start_step: int = 0, *, host_index: int = 0, host_count: int = 1
) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """Infinite (step, batch) iterator resuming at ``start_step``."""
    step = start_step
    while True:
        yield step, make_batch(cfg, step, host_index=host_index, host_count=host_count)
        step += 1
