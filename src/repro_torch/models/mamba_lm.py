"""Mamba2 language model (family ``ssm``): the model, the training loss,
prefill and decode.

Counterpart of ``repro.models.mamba_lm``.  The reference stacks the layer
parameters on a leading L axis and scans over them; here ``MambaLM``
holds an ``nn.ModuleList`` of ``MambaLayer`` walked by a Python loop.
Caches: ``{"conv": (L, B, K-1, conv_dim)`` in the compute dtype, ``"ssm":
(L, B, H, N, P)`` float32, ``"t"}``.  Embeddings are tied in mamba2.  The
path reaches no kernel (``models.ssm``).  ``mamba_loss`` is the
reference's next-token loss, each layer under ``transformer._remat``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Cache = Dict[str, Tensor]


class MambaLayer(nn.Module):
    """``ln -> SSD`` with a residual."""

    def __init__(self, ln: Tensor, mamba: nn.ParameterDict):
        super().__init__()
        self.ln = L.frozen(ln)
        self.mamba = mamba


class MambaLM(nn.Module):
    """Token embedding, the Mamba2 ``layers``, final norm and (untied
    configs only) an unembedding."""

    def __init__(self, cfg: ModelConfig, embed: Tensor, layers, final_norm: Tensor,
                 unembed: Optional[Tensor] = None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"MambaLM runs the family 'ssm', not {cfg.family!r}")
        self.cfg = cfg
        self.embed = L.frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = L.frozen(final_norm)
        self.unembed = L.frozen(unembed) if unembed is not None else None


def mamba_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> MambaLayer:
    return MambaLayer(torch.ones((cfg.d_model,), dtype=dtype, device=gen.device), S.mamba2_init(gen, cfg, dtype))


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> MambaLM:
    """Random weights for ``cfg`` from ``gen``, on the generator's device
    (``a_log``, ``dt_bias``, ``d_skip`` in float32, the rest in
    ``cfg.param_dtype``)."""
    dtype = L.dtype_of(cfg.param_dtype)
    embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers = [mamba_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    unembed = None if cfg.tie_embeddings else L.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    final_norm = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    return MambaLM(cfg, embed, layers, final_norm, unembed)


def mamba_hidden(params: MambaLM, tokens: Tensor, cfg: ModelConfig, rt: Optional[T.ParallelRuntime] = None) -> Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D), each layer under
    ``transformer._remat``."""
    x = T._embed(params, tokens, cfg)
    for lp in params.layers:
        x = T._remat(lambda xx, lp=lp: xx + S.ssd_forward(lp.mamba, L.rms_norm(xx, lp.ln, cfg.norm_eps), cfg),
                     cfg)(x)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def mamba_loss(params: MambaLM, batch: Dict[str, Tensor], cfg: ModelConfig,
               rt: Optional[T.ParallelRuntime] = None, *, backend: Optional[str] = None) -> Tensor:
    """Next-token cross entropy of ``batch`` (``tokens``, ``labels``,
    ``mask``), as ``transformer.lm_loss``.  ``backend`` is unused: the
    family reaches no kernel."""
    hidden = mamba_hidden(params, batch["tokens"], cfg, rt)
    return L.chunked_softmax_xent(lambda h: T.logits_fn(params, cfg, h), hidden, batch["labels"],
                                  batch["mask"].float(), min(cfg.logit_chunk, hidden.shape[1]))


def mamba_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Cache:
    """Zeroed caches (the module docstring's layouts) and the clock ``t``
    (a 0-d int32 tensor on the host).  ``max_seq`` is unused: the state
    does not grow with the sequence."""
    cdt = L.dtype_of(cfg.compute_dtype)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=cdt, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "t": torch.zeros((), dtype=torch.int32),
    }


def mamba_decode_step(params: MambaLM, cache: Cache, tokens: Tensor, cfg: ModelConfig,
                      rt: Optional[T.ParallelRuntime] = None) -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) float32 and the
    cache, its states written in place and ``t`` advanced.  ``rt`` changes
    nothing: the states split over the batch only."""
    x = T._embed(params, tokens, cfg)
    for i, lp in enumerate(params.layers):
        h = L.rms_norm(x, lp.ln, cfg.norm_eps)
        out, conv_st, ssm_st = S.ssd_decode(lp.mamba, h, cfg, cache["conv"][i], cache["ssm"][i])
        cache["conv"][i].copy_(conv_st)
        cache["ssm"][i].copy_(ssm_st)
        x = x + out
    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(int(cache["t"]) + 1, dtype=torch.int32)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return T.logits_fn(params, cfg, x).float(), new_cache


def mamba_prefill(
    params: MambaLM, tokens: Tensor, cfg: ModelConfig, rt: Optional[T.ParallelRuntime] = None, *,
    max_seq: Optional[int] = None,
) -> Tuple[Tensor, Cache]:
    """Sequence-parallel prefill: one chunked SSD per layer with
    ``return_state=True``; last-position logits (B, 1, V) float32 and the
    decode-ready cache.  The prompt length must suit the chunk
    (``ssm.ssd_forward`` raises :class:`ValueError` otherwise)."""
    b, s = tokens.shape
    cache = mamba_init_cache(cfg, b, max_seq or s, device=tokens.device)
    x = T._embed(params, tokens, cfg)
    for i, lp in enumerate(params.layers):
        out, conv_st, ssm_st = S.ssd_forward(lp.mamba, L.rms_norm(x, lp.ln, cfg.norm_eps), cfg, return_state=True)
        cache["conv"][i] = conv_st
        cache["ssm"][i] = ssm_st
        x = x + out
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return T.logits_fn(params, cfg, x).float(), cache
