"""Decoder-only transformer (families dense, moe and mla_moe): the model,
prefill and decode.

Counterpart of ``repro.models.transformer``.  The reference stacks layer
parameters on a leading L axis and scans over them; here the decoder is
an ``nn.Module`` whose layers are an ``nn.ModuleList`` walked by a Python
loop (PyTorch runs eagerly).  deepseek's dense first layer
(``dense_d_ff_first``) is ``Decoder.first_layer``, outside the list, as
the reference keeps it outside the scan.  The public functions keep the
reference's layouts: weights ``(d_in, d_out)``, logits ``(B, 1, V)`` in
float32, and the caches

* GQA (dense, moe): ``{"k", "v": (L, B, Hkv, S_max, hd), "t"}``;
* MLA (mla_moe): ``{"ckv": (L-1, B, S_max, r), "krope": (L-1, B, 1,
  S_max, dr), "first_ckv": (B, S_max, r), "first_krope": (B, 1, S_max,
  dr), "t"}``.

Parameters are frozen (serving only; the loss and training are not
ported, ROADMAP.md Queue 1).  GQA prefill attention runs on the flash
kernel through ``attention.attention_dispatch``; ``backend="torch"``
runs its plain version instead, on any device.  MLA and the MoE FFN
reach no kernel, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

Tensor = torch.Tensor
Cache = Dict[str, Tensor]
FAMILIES = ("dense", "moe", "mla_moe")


class DecoderLayer(nn.Module):
    """``ln1 -> attention -> ln2 -> FFN``, each with a residual.  The
    attention is ``"gqa"`` or ``"mla"``, the FFN ``"mlp"`` or ``"moe"``."""

    def __init__(
        self, ln1: Tensor, ln2: Tensor, attn: nn.ParameterDict, ffn: nn.ParameterDict,
        *, attn_kind: str = "gqa", ffn_kind: str = "mlp",
    ):
        super().__init__()
        if attn_kind not in ("gqa", "mla") or ffn_kind not in ("mlp", "moe"):
            raise ValueError(f"unknown layer kinds {attn_kind!r}, {ffn_kind!r}")
        self.ln1 = L.frozen(ln1)
        self.ln2 = L.frozen(ln2)
        self.attn = attn
        self.ffn = ffn
        self.attn_kind = attn_kind
        self.ffn_kind = ffn_kind


class Decoder(nn.Module):
    """Token embedding, an optional dense ``first_layer`` (deepseek's
    ``dense_d_ff_first``), the decoder ``layers``, final norm and (untied
    configs only) an unembedding."""

    def __init__(
        self, cfg: ModelConfig, embed: Tensor, layers, final_norm: Tensor,
        unembed: Optional[Tensor] = None, first_layer: Optional[DecoderLayer] = None,
    ):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"repro_torch's decoder runs the families {FAMILIES}, not {cfg.family!r}")
        if (first_layer is not None) != bool(cfg.dense_d_ff_first):
            raise ValueError(f"{cfg.name}: a first_layer goes with dense_d_ff_first")
        self.cfg = cfg
        self.embed = L.frozen(embed)
        self.first_layer = first_layer
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


def _layer_kinds(cfg: ModelConfig) -> Tuple[str, str]:
    attn = "mla" if cfg.family == "mla_moe" else "gqa"
    ffn = "moe" if cfg.family in ("moe", "mla_moe") else "mlp"
    return attn, ffn


def layer_init(
    gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, *, attn: str, ffn: str, d_ff: int = 0
) -> DecoderLayer:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    attn_p = A.mla_init(gen, cfg, dtype) if attn == "mla" else A.gqa_init(gen, cfg, dtype)
    ffn_p = M.moe_init(gen, cfg, dtype) if ffn == "moe" else mlp_init(gen, cfg.d_model, d_ff or cfg.d_ff, dtype)
    return DecoderLayer(ones(), ones(), attn_p, ffn_p, attn_kind=attn, ffn_kind=ffn)


def decoder_init(gen: torch.Generator, cfg: ModelConfig) -> Decoder:
    """Random weights for ``cfg`` from ``gen``, on the generator's device
    (MoE routers in float32, everything else in ``cfg.param_dtype``)."""
    dtype = L.dtype_of(cfg.param_dtype)
    attn, ffn = _layer_kinds(cfg)
    n_scan = cfg.n_layers - (1 if cfg.dense_d_ff_first else 0)
    embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers = [layer_init(gen, cfg, dtype, attn=attn, ffn=ffn) for _ in range(n_scan)]
    unembed = None if cfg.tie_embeddings else L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    first = None
    if cfg.dense_d_ff_first:
        first = layer_init(gen, cfg, dtype, attn=attn, ffn="mlp", d_ff=cfg.dense_d_ff_first)
    final_norm = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    return Decoder(cfg, embed, layers, final_norm, unembed, first_layer=first)


def _all_layers(params: Decoder):
    return ([params.first_layer] if params.first_layer is not None else []) + list(params.layers)


def _embed(params: Decoder, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params.embed[tokens].to(L.dtype_of(cfg.compute_dtype))


def _ffn_apply(lp: DecoderLayer, x: Tensor, cfg: ModelConfig) -> Tensor:
    if lp.ffn_kind == "moe":
        return M.moe_ffn(lp.ffn, x, cfg)
    return mlp_apply(lp.ffn, x)


def _layer_body(lp: DecoderLayer, x: Tensor, cfg: ModelConfig, *, backend: Optional[str]) -> Tensor:
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    if lp.attn_kind == "mla":
        x = x + A.mla_attn(lp.attn, h, cfg, causal=True)
    else:
        x = x + A.gqa_attn(lp.attn, h, cfg, causal=True, backend=backend)
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + _ffn_apply(lp, h, cfg)


def decoder_hidden(
    params: Decoder, tokens: Tensor, cfg: ModelConfig, *, backend: Optional[str] = None
) -> Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)."""
    x = _embed(params, tokens, cfg)
    for lp in _all_layers(params):
        x = _layer_body(lp, x, cfg, backend=backend)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def logits_fn(params: Decoder, cfg: ModelConfig, hidden: Tensor) -> Tensor:
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return hidden @ w.to(hidden.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Cache:
    """Zeroed caches in the compute dtype (the module docstring's layouts)
    and the position clock ``t`` (a 0-d int32 tensor on the host)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    n_scan = cfg.n_layers - (1 if cfg.dense_d_ff_first else 0)
    zeros = lambda *shape: torch.zeros(shape, dtype=cdt, device=device)
    t = torch.zeros((), dtype=torch.int32)
    if cfg.family == "mla_moe":
        r, dr = cfg.mla_kv_lora_rank, cfg.mla_rope_head_dim
        cache = {"ckv": zeros(n_scan, batch, max_seq, r), "krope": zeros(n_scan, batch, 1, max_seq, dr), "t": t}
        if cfg.dense_d_ff_first:
            cache["first_ckv"] = zeros(batch, max_seq, r)
            cache["first_krope"] = zeros(batch, 1, max_seq, dr)
        return cache
    shape = (n_scan, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": zeros(*shape), "v": zeros(*shape), "t": t}


def _layer_caches(cache: Cache, params: Decoder, cfg: ModelConfig):
    """Each layer's cache pair, in the order of ``_all_layers`` (views)."""
    if cfg.family == "mla_moe":
        first = [(cache["first_ckv"], cache["first_krope"])] if params.first_layer is not None else []
        return first + [(cache["ckv"][i], cache["krope"][i]) for i in range(len(params.layers))]
    if params.first_layer is not None:
        raise AssertionError("dense-first only used by mla_moe family")
    return [(cache["k"][i], cache["v"][i]) for i in range(len(params.layers))]


def decode_step(
    params: Decoder, cache: Cache, tokens: Tensor, cfg: ModelConfig
) -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) float32 and the
    cache, written in place at position ``t`` with ``t`` advanced."""
    x = _embed(params, tokens, cfg)
    t = int(cache["t"])
    for lp, (c0, c1) in zip(_all_layers(params), _layer_caches(cache, params, cfg)):
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        if lp.attn_kind == "mla":
            att, _, _ = A.mla_decode(lp.attn, h, cfg, c0, c1, t)
        else:
            att, _, _ = A.gqa_decode(lp.attn, h, cfg, c0, c1, t)
        x = x + att
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + _ffn_apply(lp, h, cfg)
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
    the prompt's K/V (or latents).  GQA attention is one
    ``kops.flash_attention`` per layer; MLA is the plain latent scan."""
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for lp, (c0, c1) in zip(_all_layers(params), _layer_caches(cache, params, cfg)):
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        if lp.attn_kind == "mla":
            q_nope, q_rope, c_kv, k_rope = A._mla_qkv(lp.attn, h, cfg, positions)
            c0[:, :s] = c_kv
            c1[:, :, :s] = k_rope
            att = A._mla_attend(lp.attn, q_nope, q_rope, c_kv, k_rope, cfg, causal=True)
        else:
            q, k, v = A.gqa_project_qkv(lp.attn, h, cfg, positions)
            c0[:, :, :s] = k
            c1[:, :, :s] = v
            out = A.attention_dispatch(q, k, v, causal=True, backend=backend)
            att = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp.attn["wo"]
        x = x + att
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + _ffn_apply(lp, h, cfg)
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return logits_fn(params, cfg, x).float(), cache
