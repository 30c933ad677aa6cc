"""Shared model building blocks: dtypes, initialisers, RMS and layer norm,
RoPE and sinusoidal positions, the chunked cross-entropy loss.

Counterpart of ``repro.models.layers``.
Initialisers draw from an explicit ``torch.Generator``; they give other
numbers than ``jax.random`` from the same seed, so the parity tests carry
the JAX package's weights across with ``models.convert`` instead.  The
norm and the rotary embedding upcast to float32 exactly where the
reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def frozen(t: Tensor) -> nn.Parameter:
    """``t`` as a parameter that takes no gradient.  Models are built
    frozen, for serving; the trainer (``training.train_step``) turns their
    gradients on with ``requires_grad_(True)``."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(
    gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
    *, scale: Optional[float] = None,
) -> Tensor:
    """A ``(d_in, d_out)`` weight, normal with std ``d_in**-0.5`` (or
    ``scale``), drawn in float32 on the generator's device."""
    scale = scale if scale is not None else 1.0 / (d_in ** 0.5)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: Tensor, gamma: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(dt)


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, eps: float) -> Tensor:
    """LayerNorm over the last axis with gain and bias, in float32, cast
    back to ``x``'s dtype."""
    dt = x.dtype
    out = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps)
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    """(head_dim/2,) inverse frequencies (float32).  ``theta`` stays a
    Python scalar: a tensor made from it on the card would be a blocking
    host-to-device copy on every call."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, D_head) with rotary over the last dim; positions (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d) float32: the
    sines of every frequency, then the cosines (not interleaved)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def chunked_softmax_xent(logits_fn, hidden: Tensor, labels: Tensor, mask: Tensor, chunk: int) -> Tensor:
    """Mean next-token cross entropy with the vocab projection applied per
    sequence chunk.

    ``hidden``: (B, S, D); ``logits_fn(h_chunk) -> (B, c, V)``; ``labels``
    (B, S) and ``mask`` (B, S, float32).  Each chunk's logits go to float32;
    the masked sum of the chunks' negative log likelihoods, in chunk order,
    is divided by ``max(sum(mask), 1)``.  Chunking bounds the (tokens x
    vocab) logit buffer.  S must be a multiple of ``chunk``, else
    :class:`ValueError`.
    """
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"chunked_softmax_xent: sequence {s} is not a multiple of the chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        logits = logits_fn(hidden[:, i:i + chunk]).float()            # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, i:i + chunk, None].long())[..., 0]
        total = total + torch.sum((lse - gold) * mask[:, i:i + chunk])
    return total / torch.clamp(torch.sum(mask), min=1.0)
