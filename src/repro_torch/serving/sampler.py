"""Token samplers.  Top-k and top-p run on the DPP layer (SortByKey, Scan),
as in the reference.

Counterpart of ``repro.serving.sampler``.  All samplers take float32
logits ``(B, V)``; random draws come from an explicit ``torch.Generator``
on the logits' device (other numbers than ``jax.random`` gives).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import dpp

Tensor = torch.Tensor


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0      # 0 -> greedy
    top_k: int = 0                # 0 -> disabled
    top_p: float = 1.0            # 1 -> disabled


def greedy(logits: Tensor) -> Tensor:
    """The first index of each row's maximum, int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _top_k_mask(logits: Tensor, k: int) -> Tensor:
    """Mask all but the k largest logits per row, via SortByKey (DPP).

    Sorting the negated logits ascending puts the top-k first; the k-th
    value per row is the admission threshold (ties at it are kept).
    """
    kth = torch.stack([-dpp.sort_by_key(-row)[0][k - 1] for row in logits])
    return torch.where(logits >= kth[:, None], logits, float("-inf"))


def _top_p_mask(logits: Tensor, p: float) -> Tensor:
    """Nucleus sampling mask: the smallest set of tokens with cumulative
    probability >= p.  SortByKey + Scan (DPP idiom)."""
    rows = []
    for row in logits:
        lane = torch.arange(row.shape[0], dtype=torch.int32, device=row.device)
        s_key, s_idx = dpp.sort_by_key(-row, lane)
        probs = torch.softmax(-s_key, dim=0)
        cum = dpp.scan_(probs, exclusive=True)
        keep_sorted = cum < p          # always keeps the argmax (cum[0] = 0)
        keep = torch.zeros_like(keep_sorted).scatter_(0, s_idx.long(), keep_sorted)
        rows.append(torch.where(keep, row, float("-inf")))
    return torch.stack(rows)


def sample_logits(
    logits: Tensor, gen: Optional[torch.Generator] = None, config: SamplerConfig = SamplerConfig()
) -> Tensor:
    """logits (B, V) -> token ids (B,) int32."""
    logits = logits.float()
    if config.temperature <= 0.0:
        return greedy(logits)
    logits = logits / config.temperature
    if config.top_k > 0:
        logits = _top_k_mask(logits, config.top_k)
    if config.top_p < 1.0:
        logits = _top_p_mask(logits, config.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
