"""Whisper-style encoder-decoder (family ``encdec``): the encoder over
precomputed frame embeddings, the decoder with causal self-attention and
cross-attention over the encoder's output, the training loss, prefill and
decode.

Counterpart of ``repro.models.whisper``.  As in the reference the audio
frontend is a stub: a request brings frame embeddings ``(B, S_enc, D)``,
which pass through one linear ``frontend_proj`` standing in for the conv
stack's output layer.  The encoder adds fixed sinusoidal positions and
attends both ways; the decoder adds learned positions (``pos_embed``,
``(max_seq, D)``) and ties its output projection to ``embed``.  LayerNorm
with bias throughout; the MLP is the reference's SwiGLU
(``transformer.mlp_apply``), not the published Whisper's GELU.

The reference stacks each stack's layers on a leading L axis and scans;
here ``enc_layers`` and ``dec_layers`` are ``nn.ModuleList``s of
``nn.ParameterDict``s keyed as the reference's layer dicts (each norm a
``{"g", "b"}`` dict), walked by a Python loop.

Attention: the encoder's self-attention (bidirectional) and the decoder's
prefill self-attention (causal) go through ``attention.attention_dispatch``,
the flash kernel for a CUDA tensor (``backend="torch"``: its plain
version).  Cross-attention (Sq != Sk) and every decode step run the plain
``chunked_attention``, as in the reference: the kernel takes one S for q
and k/v.  Prefill computes each layer's cross K/V once, for the cache and
for its own cross-attention (the reference computes them twice).

Caches: ``{"k", "v": (L, B, Hkv, S_max, hd)`` (decoder self-attention),
``"xk", "xv": (L, B, Hkv, encoder_seq, hd)`` (cross K/V from the encoder
output), ``"t"}``.  Frames of another length than ``cfg.encoder_seq``
raise :class:`ValueError`.  ``whisper_loss`` is the reference's
next-token loss over ``encode`` and ``decode_hidden``, whose layers run
under ``transformer._remat``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Tensor = torch.Tensor
Cache = Dict[str, Tensor]
ENC_PARTS = ("ln1", "attn", "ln2", "mlp")
DEC_PARTS = ("ln1", "self_attn", "ln2", "cross_attn", "ln3", "mlp")


class Whisper(nn.Module):
    """``frontend_proj``, the encoder layers and ``enc_norm``; the tied
    ``embed``, the learned ``pos_embed``, the decoder layers and
    ``dec_norm``.  Each layer is an ``nn.ParameterDict`` with the keys
    ``ENC_PARTS`` or ``DEC_PARTS``; each norm a ``{"g", "b"}`` one."""

    def __init__(
        self, cfg: ModelConfig, frontend_proj: Tensor, enc_layers, enc_norm: nn.ParameterDict,
        embed: Tensor, pos_embed: Tensor, dec_layers, dec_norm: nn.ParameterDict,
    ):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"Whisper runs the family 'encdec', not {cfg.family!r}")
        for layers, parts, n in ((enc_layers, ENC_PARTS, cfg.encoder_layers), (dec_layers, DEC_PARTS, cfg.n_layers)):
            if len(layers) != n or any(set(lp.keys()) != set(parts) for lp in layers):
                raise ValueError(f"{cfg.name}: expected {n} layers with the parts {parts}")
        self.cfg = cfg
        self.frontend_proj = L.frozen(frontend_proj)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.enc_norm = enc_norm
        self.embed = L.frozen(embed)
        self.pos_embed = L.frozen(pos_embed)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.dec_norm = dec_norm


def ln_params(g: Tensor, b: Tensor) -> nn.ParameterDict:
    return nn.ParameterDict({"g": L.frozen(g), "b": L.frozen(b)})


def _ln_init(cfg: ModelConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    d = cfg.d_model
    return ln_params(torch.ones((d,), dtype=dtype, device=device), torch.zeros((d,), dtype=dtype, device=device))


def _ln(x: Tensor, p, eps: float) -> Tensor:
    return L.layer_norm(x, p["g"], p["b"], eps)


def whisper_init(gen: torch.Generator, cfg: ModelConfig) -> Whisper:
    """Random weights for ``cfg`` from ``gen``, on the generator's device,
    in ``cfg.param_dtype`` (the reference's scales: ``pos_embed`` normal
    times 0.01)."""
    dtype = L.dtype_of(cfg.param_dtype)
    dev = gen.device
    ln = lambda: _ln_init(cfg, dtype, dev)
    frontend = L.dense_init(gen, cfg.d_model, cfg.d_model, dtype)
    enc = [nn.ParameterDict({"ln1": ln(), "attn": A.gqa_init(gen, cfg, dtype), "ln2": ln(),
                             "mlp": T.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)})
           for _ in range(cfg.encoder_layers)]
    enc_norm = ln()
    embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    pos = torch.randn((cfg.max_seq, cfg.d_model), generator=gen, device=dev, dtype=torch.float32)
    pos_embed = (pos * 0.01).to(dtype)
    dec = [nn.ParameterDict({"ln1": ln(), "self_attn": A.gqa_init(gen, cfg, dtype), "ln2": ln(),
                             "cross_attn": A.gqa_init(gen, cfg, dtype), "ln3": ln(),
                             "mlp": T.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)})
           for _ in range(cfg.n_layers)]
    return Whisper(cfg, frontend, enc, enc_norm, embed, pos_embed, dec, ln())


def encode(params: Whisper, frames: Tensor, cfg: ModelConfig, rt: Optional[T.ParallelRuntime] = None, *,
           backend: Optional[str] = None) -> Tensor:
    """frames (B, S_enc, D) -> the encoder's output (B, S_enc, D) in the
    compute dtype.  Each layer's self-attention is one bidirectional
    ``attention_dispatch``."""
    cdt = L.dtype_of(cfg.compute_dtype)
    s = frames.shape[1]
    x = frames.to(cdt) @ params.frontend_proj
    x = x + L.sinusoidal_positions(s, cfg.d_model, device=x.device).to(cdt)[None]
    for lp in params.enc_layers:
        x = T._remat(lambda xx, lp=lp: _enc_layer(lp, xx, cfg, backend), cfg)(x)
    return _ln(x, params.enc_norm, cfg.norm_eps)


def _enc_layer(lp, x: Tensor, cfg: ModelConfig, backend: Optional[str]) -> Tensor:
    h = _ln(x, lp["ln1"], cfg.norm_eps)
    x = x + A.gqa_attn(lp["attn"], h, cfg, causal=False, rope=False, backend=backend)
    h = _ln(x, lp["ln2"], cfg.norm_eps)
    return x + T.mlp_apply(lp["mlp"], h)


def _cross_kv(p, memory: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """The cross-attention's K and V (B, Hkv, S_enc, hd) from the encoder
    output ``memory`` (B, S_enc, D)."""
    b, sm, _ = memory.shape
    shape = (b, sm, cfg.n_kv_heads, cfg.head_dim)
    return (memory @ p["wk"]).reshape(shape).transpose(1, 2), (memory @ p["wv"]).reshape(shape).transpose(1, 2)


def _cross_attend(p, x: Tensor, xk: Tensor, xv: Tensor, cfg: ModelConfig) -> Tensor:
    """Cross-attention of the decoder states ``x`` (B, S, D) over the
    encoder's K/V (B, Hkv, S_enc, hd): the plain ``chunked_attention``, no
    mask."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    out = A.chunked_attention(q, xk, xv, causal=False, chunk=cfg.attn_chunk)
    return out.transpose(1, 2).reshape(b, s, hq * hd) @ p["wo"]


def _embed_tokens(params: Whisper, tokens: Tensor, cfg: ModelConfig, start: int) -> Tensor:
    """Token embeddings plus the learned positions ``start`` onward, in the
    compute dtype (a view of ``pos_embed``: no copy from the host)."""
    x = T._embed(params, tokens, cfg)
    return x + params.pos_embed[start:start + tokens.shape[1]].to(x.dtype)[None]


def _logits(params: Whisper, x: Tensor) -> Tensor:
    return (x @ params.embed.T.to(x.dtype)).float()


def decode_hidden(
    params: Whisper, tokens: Tensor, memory: Tensor, cfg: ModelConfig, rt: Optional[T.ParallelRuntime] = None, *,
    backend: Optional[str] = None,
) -> Tensor:
    """Token ids (B, S) and the encoder output (B, S_enc, D) -> the
    decoder's final hidden states (B, S, D)."""
    x = _embed_tokens(params, tokens, cfg, 0)
    for lp in params.dec_layers:
        x = T._remat(lambda xx, lp=lp: _dec_layer(lp, xx, memory, cfg, backend), cfg)(x)
    return _ln(x, params.dec_norm, cfg.norm_eps)


def _dec_layer(lp, x: Tensor, memory: Tensor, cfg: ModelConfig, backend: Optional[str]) -> Tensor:
    h = _ln(x, lp["ln1"], cfg.norm_eps)
    x = x + A.gqa_attn(lp["self_attn"], h, cfg, causal=True, rope=False, backend=backend)
    h = _ln(x, lp["ln2"], cfg.norm_eps)
    x = x + _cross_attend(lp["cross_attn"], h, *_cross_kv(lp["cross_attn"], memory, cfg), cfg)
    h = _ln(x, lp["ln3"], cfg.norm_eps)
    return x + T.mlp_apply(lp["mlp"], h)


def whisper_loss(params: Whisper, batch: Dict[str, Tensor], cfg: ModelConfig,
                 rt: Optional[T.ParallelRuntime] = None, *, backend: Optional[str] = None) -> Tensor:
    """Next-token cross entropy of ``batch`` (``frames`` (B, encoder_seq,
    D), ``tokens``, ``labels``, ``mask``) through the encoder and the
    decoder, the output projection tied to ``embed``."""
    memory = encode(params, batch["frames"], cfg, rt, backend=backend)
    hidden = decode_hidden(params, batch["tokens"], memory, cfg, rt, backend=backend)
    return L.chunked_softmax_xent(lambda h: h @ params.embed.T.to(h.dtype), hidden, batch["labels"],
                                  batch["mask"].float(), min(cfg.logit_chunk, hidden.shape[1]))


def whisper_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Cache:
    """Zeroed caches in the compute dtype (the module docstring's layouts)
    and the clock ``t`` (a 0-d int32 tensor on the host)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    zeros = lambda s: torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim), dtype=cdt, device=device)
    return {"k": zeros(max_seq), "v": zeros(max_seq), "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq),
            "t": torch.zeros((), dtype=torch.int32)}


def whisper_prefill(
    params: Whisper, tokens: Tensor, frames: Optional[Tensor], cfg: ModelConfig,
    rt: Optional[T.ParallelRuntime] = None, *, max_seq: Optional[int] = None, backend: Optional[str] = None,
) -> Tuple[Tensor, Cache]:
    """Encode ``frames`` (B, encoder_seq, D), then prefill the decoder over
    ``tokens`` (B, S): last-position logits (B, 1, V) float32 and a cache
    of ``max_seq`` positions (default S) holding the prompt's K/V and
    every layer's cross K/V."""
    b, s = tokens.shape
    want = (b, cfg.encoder_seq, cfg.d_model)
    if frames is None or tuple(frames.shape) != want:
        got = None if frames is None else tuple(frames.shape)
        raise ValueError(f"{cfg.name}: prefill needs frames of shape {want}, got {got}")
    max_seq = max_seq or s
    memory = encode(params, frames, cfg, rt, backend=backend)
    cache = whisper_init_cache(cfg, b, max_seq, device=tokens.device)
    x = _embed_tokens(params, tokens, cfg, 0)
    for i, lp in enumerate(params.dec_layers):
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        q, k, v = A.gqa_project_qkv(lp["self_attn"], h, cfg, None, rope=False)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
        out = A.attention_dispatch(q, k, v, causal=True, backend=backend)
        x = x + out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["self_attn"]["wo"]
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        xk, xv = _cross_kv(lp["cross_attn"], memory, cfg)
        cache["xk"][i] = xk
        cache["xv"][i] = xv
        x = x + _cross_attend(lp["cross_attn"], h, cache["xk"][i], cache["xv"][i], cfg)
        h = _ln(x, lp["ln3"], cfg.norm_eps)
        x = x + T.mlp_apply(lp["mlp"], h)
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    return _logits(params, _ln(x[:, -1:], params.dec_norm, cfg.norm_eps)), cache


def whisper_decode_step(params: Whisper, cache: Cache, tokens: Tensor, cfg: ModelConfig,
                        rt: Optional[T.ParallelRuntime] = None) -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) float32 and the
    cache, self-attention K/V written in place at position ``t`` (a host
    int, as ``gqa_decode`` takes it) with ``t`` advanced.  With
    ``rt.seq_axis`` the self-attention caches are this rank's sequence
    slices; the cross caches stay whole."""
    t = int(cache["t"])
    x = _embed_tokens(params, tokens, cfg, t)
    for i, lp in enumerate(params.dec_layers):
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        att, _, _ = A.gqa_decode(lp["self_attn"], h, cfg, cache["k"][i], cache["v"][i], t, rope=False, rt=rt)
        x = x + att
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        x = x + _cross_attend(lp["cross_attn"], h, cache["xk"][i], cache["xv"][i], cfg)
        h = _ln(x, lp["ln3"], cfg.norm_eps)
        x = x + T.mlp_apply(lp["mlp"], h)
    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    return _logits(params, _ln(x, params.dec_norm, cfg.norm_eps)), new_cache
