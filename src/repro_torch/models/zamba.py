"""Zamba2-style hybrid (family ``hybrid``): a Mamba2 backbone and one
weight-shared attention block.

Counterpart of ``repro.models.zamba``.  With ``k = cfg.hybrid_attn_every``
the L Mamba layers form ``n_apps = L / k`` groups; after each group the
one ``shared`` (attention + MLP) block is applied, the same weights every
time (held once, never copied per application).  The reference views the
stacked layers as ``(n_apps, k, ...)`` and nests two scans; here
application ``a`` runs layers ``a·k .. a·k + k - 1`` of one
``nn.ModuleList``.

Caches: ``{"conv": (L, B, K-1, conv_dim)``, ``"ssm": (L, B, H, N, P)``
float32, ``"k", "v": (n_apps, B, Hkv, S_max, hd)`` (each application its
own), ``"t"}``.  Prefill attention is ``attention.attention_dispatch``
(the flash kernel for a CUDA tensor; ``backend="torch"`` its plain
version), decode ``attention.gqa_decode``.  ``zamba_loss`` is the
reference's next-token loss: each Mamba layer under
``transformer._remat``, the shared block not (as in the reference).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba_lm as MB
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Cache = Dict[str, Tensor]


class SharedBlock(nn.Module):
    """``ln1 -> GQA attention -> ln2 -> MLP``, each with a residual."""

    def __init__(self, ln1: Tensor, attn: nn.ParameterDict, ln2: Tensor, mlp: nn.ParameterDict):
        super().__init__()
        self.ln1 = L.frozen(ln1)
        self.attn = attn
        self.ln2 = L.frozen(ln2)
        self.mlp = mlp


class Zamba(nn.Module):
    """Token embedding, the Mamba2 ``mamba_layers``, the ``shared`` block,
    final norm and (untied configs only) an unembedding."""

    def __init__(self, cfg: ModelConfig, embed: Tensor, mamba_layers, shared: SharedBlock,
                 final_norm: Tensor, unembed: Optional[Tensor] = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba runs the family 'hybrid', not {cfg.family!r}")
        _n_apps(cfg)
        self.cfg = cfg
        self.embed = L.frozen(embed)
        self.mamba_layers = nn.ModuleList(mamba_layers)
        self.shared = shared
        self.final_norm = L.frozen(final_norm)
        self.unembed = L.frozen(unembed) if unembed is not None else None


def _n_apps(cfg: ModelConfig) -> int:
    k = cfg.hybrid_attn_every
    if not k or cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of hybrid_attn_every = {k}")
    return cfg.n_layers // k


def zamba_init(gen: torch.Generator, cfg: ModelConfig) -> Zamba:
    """Random weights for ``cfg`` from ``gen``, on the generator's device."""
    dtype = L.dtype_of(cfg.param_dtype)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    mamba_layers = [MB.mamba_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    shared = SharedBlock(ones(), A.gqa_init(gen, cfg, dtype), ones(), T.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype))
    unembed = None if cfg.tie_embeddings else L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return Zamba(cfg, embed, mamba_layers, shared, ones(), unembed)


def _mamba_block(lp: MB.MambaLayer, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x + S.ssd_forward(lp.mamba, L.rms_norm(x, lp.ln, cfg.norm_eps), cfg)


def _shared_block(sp: SharedBlock, x: Tensor, cfg: ModelConfig, rt=None, *, backend: Optional[str] = None) -> Tensor:
    h = L.rms_norm(x, sp.ln1, cfg.norm_eps)
    x = x + A.gqa_attn(sp.attn, h, cfg, causal=True, backend=backend, rt=rt)
    h = L.rms_norm(x, sp.ln2, cfg.norm_eps)
    return x + T.mlp_apply(sp.mlp, h)


def _app_layers(params: Zamba, cfg: ModelConfig, a: int):
    """Application ``a``'s Mamba layers, with their indices."""
    k = cfg.hybrid_attn_every
    return [(i, params.mamba_layers[i]) for i in range(a * k, (a + 1) * k)]


def zamba_hidden(params: Zamba, tokens: Tensor, cfg: ModelConfig, rt: Optional[T.ParallelRuntime] = None, *,
                 backend: Optional[str] = None) -> Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D)."""
    x = T._embed(params, tokens, cfg)
    for a in range(_n_apps(cfg)):
        for _, lp in _app_layers(params, cfg, a):
            x = T._remat(lambda xx, lp=lp: _mamba_block(lp, xx, cfg), cfg)(x)
        x = _shared_block(params.shared, x, cfg, rt, backend=backend)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def zamba_loss(params: Zamba, batch: Dict[str, Tensor], cfg: ModelConfig,
               rt: Optional[T.ParallelRuntime] = None, *, backend: Optional[str] = None) -> Tensor:
    """Next-token cross entropy of ``batch`` (``tokens``, ``labels``,
    ``mask``), as ``transformer.lm_loss``; the shared block's attention
    on the flash kernel (``backend`` as in ``zamba_hidden``)."""
    hidden = zamba_hidden(params, batch["tokens"], cfg, rt, backend=backend)
    return L.chunked_softmax_xent(lambda h: T.logits_fn(params, cfg, h), hidden, batch["labels"],
                                  batch["mask"].float(), min(cfg.logit_chunk, hidden.shape[1]))


def zamba_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Cache:
    """Zeroed caches (the module docstring's layouts) and the clock ``t``
    (a 0-d int32 tensor on the host)."""
    cache = MB.mamba_init_cache(cfg, batch, max_seq, device=device)
    shape = (_n_apps(cfg), batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    cdt = L.dtype_of(cfg.compute_dtype)
    cache["k"] = torch.zeros(shape, dtype=cdt, device=device)
    cache["v"] = torch.zeros(shape, dtype=cdt, device=device)
    return cache


def zamba_prefill(
    params: Zamba, tokens: Tensor, cfg: ModelConfig, rt: Optional[T.ParallelRuntime] = None, *,
    max_seq: Optional[int] = None, backend: Optional[str] = None,
) -> Tuple[Tensor, Cache]:
    """Sequence-parallel prefill: a chunked SSD with state extraction per
    Mamba layer, and per shared-block application one
    ``attention_dispatch`` (flash) that also fills the application's K/V
    cache.  Last-position logits (B, 1, V) float32 and the cache."""
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = zamba_init_cache(cfg, b, max_seq, device=tokens.device)
    x = T._embed(params, tokens, cfg)
    sp = params.shared
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for a in range(_n_apps(cfg)):
        for i, lp in _app_layers(params, cfg, a):
            h = L.rms_norm(x, lp.ln, cfg.norm_eps)
            out, conv_st, ssm_st = S.ssd_forward(lp.mamba, h, cfg, return_state=True)
            cache["conv"][i] = conv_st
            cache["ssm"][i] = ssm_st
            x = x + out
        h = L.rms_norm(x, sp.ln1, cfg.norm_eps)
        q, k, v = A.gqa_project_qkv(sp.attn, h, cfg, positions)
        cache["k"][a, :, :, :s] = k
        cache["v"][a, :, :, :s] = v
        att = A.attention_dispatch(q, k, v, causal=True, backend=backend)
        x = x + att.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ sp.attn["wo"]
        h = L.rms_norm(x, sp.ln2, cfg.norm_eps)
        x = x + T.mlp_apply(sp.mlp, h)
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return T.logits_fn(params, cfg, x).float(), cache


def zamba_decode_step(params: Zamba, cache: Cache, tokens: Tensor, cfg: ModelConfig,
                      rt: Optional[T.ParallelRuntime] = None) -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) float32 and the
    cache, written in place (K/V at position ``t``) with ``t`` advanced.
    With ``rt.seq_axis`` the shared block's K/V caches are this rank's
    sequence slices (``attention.gqa_decode``'s hook)."""
    x = T._embed(params, tokens, cfg)
    t = int(cache["t"])
    sp = params.shared
    for a in range(_n_apps(cfg)):
        for i, lp in _app_layers(params, cfg, a):
            h = L.rms_norm(x, lp.ln, cfg.norm_eps)
            out, conv_st, ssm_st = S.ssd_decode(lp.mamba, h, cfg, cache["conv"][i], cache["ssm"][i])
            cache["conv"][i].copy_(conv_st)
            cache["ssm"][i].copy_(ssm_st)
            x = x + out
        h = L.rms_norm(x, sp.ln1, cfg.norm_eps)
        att, _, _ = A.gqa_decode(sp.attn, h, cfg, cache["k"][a], cache["v"][a], t, rt=rt)
        x = x + att
        h = L.rms_norm(x, sp.ln2, cfg.norm_eps)
        x = x + T.mlp_apply(sp.mlp, h)
    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return T.logits_fn(params, cfg, x).float(), new_cache
