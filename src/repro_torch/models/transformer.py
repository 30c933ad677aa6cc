"""Decoder-only transformer, dense family: the model, prefill and decode.

Counterpart of ``repro.models.transformer`` for ``family == "dense"``.
The reference stacks layer parameters on a leading L axis and scans over
them; here the decoder is an ``nn.Module`` whose layers are an
``nn.ModuleList`` walked by a Python loop (PyTorch runs eagerly).  The
public functions keep the reference's layouts: weights ``(d_in, d_out)``,
caches ``{"k", "v": (L, B, Hkv, S_max, hd), "t": scalar}``, logits ``(B,
1, V)`` in float32.  Parameters are frozen (serving only; the loss and
training are not ported, ROADMAP.md Queue 1).

Prefill attention runs on the flash kernel through
``attention.attention_dispatch``; ``backend="torch"`` runs its plain
version instead, on any device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Tensor = torch.Tensor
Cache = Dict[str, Tensor]


class DecoderLayer(nn.Module):
    """``ln1 -> attention -> ln2 -> MLP``, each with a residual."""

    def __init__(self, ln1: Tensor, ln2: Tensor, attn: nn.ParameterDict, mlp: nn.ParameterDict):
        super().__init__()
        self.ln1 = L.frozen(ln1)
        self.ln2 = L.frozen(ln2)
        self.attn = attn
        self.mlp = mlp


class Decoder(nn.Module):
    """Token embedding, ``cfg.n_layers`` decoder layers, final norm and
    (untied configs only) an unembedding."""

    def __init__(
        self, cfg: ModelConfig, embed: Tensor, layers, final_norm: Tensor,
        unembed: Optional[Tensor] = None,
    ):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"repro_torch's decoder runs the dense family, not {cfg.family!r}")
        self.cfg = cfg
        self.embed = L.frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.frozen(final_norm)
        self.unembed = L.frozen(unembed) if unembed is not None else None


def mlp_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w_gate": L.frozen(L.dense_init(gen, d, f, dtype)),
        "w_up": L.frozen(L.dense_init(gen, d, f, dtype)),
        "w_down": L.frozen(L.dense_init(gen, f, d, dtype)),
    })


def mlp_apply(p, x: Tensor) -> Tensor:
    h = torch.nn.functional.silu((x @ p["w_gate"]).float()).to(x.dtype)
    return (h * (x @ p["w_up"])) @ p["w_down"]


def decoder_init(gen: torch.Generator, cfg: ModelConfig) -> Decoder:
    """Random weights for ``cfg`` from ``gen``, on the generator's device."""
    dtype = L.dtype_of(cfg.param_dtype)
    dev = gen.device
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers = [
        DecoderLayer(ones(), ones(), A.gqa_init(gen, cfg, dtype), mlp_init(gen, cfg.d_model, cfg.d_ff, dtype))
        for _ in range(cfg.n_layers)
    ]
    unembed = None if cfg.tie_embeddings else L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return Decoder(cfg, embed, layers, ones(), unembed)


def _embed(params: Decoder, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params.embed[tokens].to(L.dtype_of(cfg.compute_dtype))


def _layer_body(lp: DecoderLayer, x: Tensor, cfg: ModelConfig, *, backend: Optional[str]) -> Tensor:
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + A.gqa_attn(lp.attn, h, cfg, causal=True, backend=backend)
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_apply(lp.mlp, h)


def decoder_hidden(
    params: Decoder, tokens: Tensor, cfg: ModelConfig, *, backend: Optional[str] = None
) -> Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)."""
    x = _embed(params, tokens, cfg)
    for lp in params.layers:
        x = _layer_body(lp, x, cfg, backend=backend)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def logits_fn(params: Decoder, cfg: ModelConfig, hidden: Tensor) -> Tensor:
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return hidden @ w.to(hidden.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Cache:
    """Zeroed K/V caches ``(L, B, Hkv, max_seq, hd)`` in the compute dtype
    and the position clock ``t`` (a 0-d int32 tensor on the host)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cdt, device=device),
        "v": torch.zeros(shape, dtype=cdt, device=device),
        "t": torch.zeros((), dtype=torch.int32),
    }


def decode_step(
    params: Decoder, cache: Cache, tokens: Tensor, cfg: ModelConfig
) -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) float32 and the
    cache, written in place at position ``t`` with ``t`` advanced."""
    x = _embed(params, tokens, cfg)
    t = int(cache["t"])
    for i, lp in enumerate(params.layers):
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        att, _, _ = A.gqa_decode(lp.attn, h, cfg, cache["k"][i], cache["v"][i], t)
        x = x + att
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, h)
    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_fn(params, cfg, x).float(), new_cache


def prefill(
    params: Decoder, tokens: Tensor, cfg: ModelConfig, *,
    max_seq: Optional[int] = None, backend: Optional[str] = None,
) -> Tuple[Tensor, Cache]:
    """Process a full prompt: last-position logits (B, 1, V) float32 and a
    cache of ``max_seq`` positions (default: the prompt length) holding
    the prompt's K/V.  Attention is one ``kops.flash_attention`` per layer."""
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for i, lp in enumerate(params.layers):
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k, v = A.gqa_project_qkv(lp.attn, h, cfg, positions)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
        out = A.attention_dispatch(q, k, v, causal=True, backend=backend)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
        x = x + out @ lp.attn["wo"]
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + mlp_apply(lp.mlp, h)
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return logits_fn(params, cfg, x).float(), cache
