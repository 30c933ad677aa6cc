"""Decoder-only transformer (families dense, vlm, moe and mla_moe): the
model, the training loss, prefill and decode.

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

Parameters are built frozen (serving); the trainer turns their gradients
on.  ``lm_loss`` is the reference's next-token loss over
``decoder_hidden``, each scanned layer under ``_remat`` (``cfg.remat_policy``:
``none``; ``full`` recomputes the whole layer in the backward pass;
``dots`` keeps the matrix products' outputs and recomputes the rest;
``dots_nb`` keeps only the weight products).  GQA
attention, in training and prefill, runs on the flash kernel through
``attention.attention_dispatch`` (``kernels.ops.FlashAttention`` under
autograd); ``backend="torch"`` runs its plain version instead, on any
device.  MLA and the MoE FFN reach no kernel, as in the reference.

The mesh runtime ``rt`` (:class:`ParallelRuntime`, None on one device)
is threaded through ``decoder_hidden``, ``lm_loss``, ``prefill`` and
``decode_step`` as in the reference.  With ``rt.active`` the MoE FFN
runs expert-parallel over ``rt.tp_axis`` (``moe.moe_ffn(axis=...)``),
and with ``rt.seq_axis`` decode attends over a sequence-split cache
(``parallel.sp_attention``).  Everything else is the single-device code:
a rank's activations are its local tensors (``shard_act`` is a no-op).

``vlm`` (llava) is the dense decoder with patch embeddings ``(B, P, D)``
spliced into the prompt: they replace the first P token embeddings, cast
to the compute dtype, and positions run over the whole prompt.  The
vision tower is a stub in the reference too; decode takes tokens only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

Tensor = torch.Tensor
Cache = Dict[str, Tensor]
FAMILIES = ("dense", "vlm", "moe", "mla_moe")


class ParallelRuntime(NamedTuple):
    """Mesh context threaded through model calls (None = single device)."""

    mesh: Any = None                # a DeviceMesh
    dp_axes: Tuple[str, ...] = ()   # batch-sharding axes, e.g. ("pod","data")
    tp_axis: str = ""               # expert-parallel axis ("model")
    seq_axis: str = ""              # cache-sequence split axis for decode
                                    # (sp_attention flash combine); "" = off
    decode_batch_spec: Any = None   # the reference's decode batch entry (unused:
                                    # a rank's rows are local tensors)
    pin_attn_seq: bool = True       # the reference's GSPMD pin; no effect here

    @property
    def active(self) -> bool:
        return self.mesh is not None


def shard_act(x: Tensor, rt: Optional[ParallelRuntime], *axes) -> Tensor:
    """The reference's activation sharding constraint: a no-op, since a
    rank's activations are its local tensors already."""
    return x


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


def _embed(params: nn.Module, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params.embed[tokens].to(L.dtype_of(cfg.compute_dtype))


def _splice_patches(x: Tensor, vision_embeds: Tensor) -> Tensor:
    """The token embeddings ``x`` (B, S, D) with the first P replaced by
    the patch embeddings (B, P, D), cast to ``x``'s dtype."""
    npatch = vision_embeds.shape[1]
    if x.shape[1] < npatch:
        raise ValueError(f"a prompt of {x.shape[1]} tokens cannot hold {npatch} patch embeddings")
    return torch.cat([vision_embeds.to(x.dtype), x[:, npatch:]], dim=1)


def _ffn_apply(lp: DecoderLayer, x: Tensor, cfg: ModelConfig, rt: Optional[ParallelRuntime] = None) -> Tensor:
    """The layer's FFN; under an active runtime with a ``tp_axis`` the MoE
    FFN is expert-parallel over that axis's group (the layer's expert
    stacks hold this rank's experts)."""
    if lp.ffn_kind == "moe":
        ep = rt is not None and rt.active and rt.tp_axis
        return M.moe_ffn(lp.ffn, x, cfg, axis=rt.mesh.get_group(rt.tp_axis) if ep else None)
    return mlp_apply(lp.ffn, x)


def _layer_body(lp: DecoderLayer, x: Tensor, cfg: ModelConfig, rt: Optional[ParallelRuntime] = None, *,
                backend: Optional[str]) -> Tensor:
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    if lp.attn_kind == "mla":
        x = x + A.mla_attn(lp.attn, h, cfg, causal=True, rt=rt)
    else:
        x = x + A.gqa_attn(lp.attn, h, cfg, causal=True, backend=backend, rt=rt)
    x = shard_act(x, rt, rt.dp_axes if rt else None, None, None)
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + _ffn_apply(lp, h, cfg, rt)


_aten = torch.ops.aten
#: Per ``remat_policy``, the ops whose outputs a checkpointed layer keeps
#: (None: nothing is checkpointed).  ``dots`` is the reference's
#: ``dots_saveable`` (every matrix product, attention's plain products
#: included), ``dots_nb`` its ``checkpoint_dots_with_no_batch_dims`` (the
#: weight products only), ``full`` its ``nothing_saveable``.  The flash
#: kernel's output is no aten op: it is recomputed under every policy.
REMAT_SAVED = {
    "none": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default),
    "dots_nb": (_aten.mm.default, _aten.addmm.default),
    "full": (),
}


def _remat(fn: Callable[[Tensor], Tensor], cfg: ModelConfig) -> Callable[[Tensor], Tensor]:
    """``fn`` (one layer, activations -> activations) under
    ``cfg.remat_policy``: checkpointed (``torch.utils.checkpoint``,
    non-reentrant), keeping the outputs of the policy's ``REMAT_SAVED`` ops
    and recomputing the rest in the backward pass.  ``none``, or where
    autograd does not record: ``fn`` as it is."""
    if cfg.remat_policy not in REMAT_SAVED:
        raise ValueError(f"{cfg.name}: unknown remat_policy {cfg.remat_policy!r}; have {tuple(REMAT_SAVED)}")
    saved = REMAT_SAVED[cfg.remat_policy]
    if saved is None or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": lambda: _ckpt.create_selective_checkpoint_contexts(list(saved))} if saved else {}
    return lambda x: _ckpt.checkpoint(fn, x, use_reentrant=False, **kw)


def decoder_hidden(
    params: Decoder, tokens: Tensor, cfg: ModelConfig, rt: Optional[ParallelRuntime] = None, *,
    backend: Optional[str] = None, vision_embeds: Optional[Tensor] = None,
) -> Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D).  ``vlm`` needs
    ``vision_embeds`` (B, P, D).  Each layer of ``layers`` runs under
    ``_remat`` (deepseek's ``first_layer`` does not, as in the reference)."""
    x = _embed(params, tokens, cfg)
    if cfg.family == "vlm":
        if vision_embeds is None:
            raise ValueError(f"{cfg.name}: the vlm family needs vision_embeds")
        x = _splice_patches(x, vision_embeds)
    x = shard_act(x, rt, rt.dp_axes if rt else None, None, None)
    if params.first_layer is not None:
        x = _layer_body(params.first_layer, x, cfg, rt, backend=backend)
    for lp in params.layers:
        x = _remat(lambda xx, lp=lp: _layer_body(lp, xx, cfg, rt, backend=backend), cfg)(x)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps)


def logits_fn(params: Decoder, cfg: ModelConfig, hidden: Tensor) -> Tensor:
    w = params.embed.T if cfg.tie_embeddings else params.unembed
    return hidden @ w.to(hidden.dtype)


def lm_loss(params: Decoder, batch: Dict[str, Tensor], cfg: ModelConfig,
            rt: Optional[ParallelRuntime] = None, *, backend: Optional[str] = None) -> Tensor:
    """Next-token cross entropy (a 0-d float32 tensor) of ``batch``
    (``tokens``, ``labels``, ``mask``, and for ``vlm`` ``vision_embeds``),
    the vocab projection per ``min(cfg.logit_chunk, S)`` positions.  As in
    the reference, no MoE auxiliary loss is added."""
    hidden = decoder_hidden(params, batch["tokens"], cfg, rt, backend=backend,
                            vision_embeds=batch.get("vision_embeds"))
    return L.chunked_softmax_xent(lambda h: logits_fn(params, cfg, h), hidden, batch["labels"],
                                  batch["mask"].float(), min(cfg.logit_chunk, hidden.shape[1]))


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
    params: Decoder, cache: Cache, tokens: Tensor, cfg: ModelConfig, rt: Optional[ParallelRuntime] = None,
) -> Tuple[Tensor, Cache]:
    """One decode step.  tokens: (B, 1) -> logits (B, 1, V) float32 and the
    cache, written in place at position ``t`` with ``t`` advanced.  With
    ``rt.seq_axis`` the caches are this rank's sequence slices."""
    x = _embed(params, tokens, cfg)
    t = int(cache["t"])
    for lp, (c0, c1) in zip(_all_layers(params), _layer_caches(cache, params, cfg)):
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        if lp.attn_kind == "mla":
            att, _, _ = A.mla_decode(lp.attn, h, cfg, c0, c1, t, rt=rt)
        else:
            att, _, _ = A.gqa_decode(lp.attn, h, cfg, c0, c1, t, rt=rt)
        x = x + att
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        x = x + _ffn_apply(lp, h, cfg, rt)
    new_cache = dict(cache)
    new_cache["t"] = torch.tensor(t + 1, dtype=torch.int32)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_fn(params, cfg, x).float(), new_cache


def prefill(
    params: Decoder, tokens: Tensor, cfg: ModelConfig, rt: Optional[ParallelRuntime] = None, *,
    max_seq: Optional[int] = None, backend: Optional[str] = None,
    vision_embeds: Optional[Tensor] = None,
) -> Tuple[Tensor, Cache]:
    """Process a full prompt: last-position logits (B, 1, V) float32 and a
    cache of ``max_seq`` positions (default: the prompt length) holding
    the prompt's K/V (or latents).  GQA attention is one
    ``kops.flash_attention`` per layer; MLA is the plain latent scan.
    For ``vlm``, ``vision_embeds`` (B, P, D), where given, replace the
    first P token embeddings (as the reference's prefill, which takes
    them as optional)."""
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    x = _embed(params, tokens, cfg)
    if cfg.family == "vlm" and vision_embeds is not None:
        x = _splice_patches(x, vision_embeds)
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
        x = x + _ffn_apply(lp, h, cfg, rt)
    cache["t"] = torch.tensor(s, dtype=torch.int32)
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return logits_fn(params, cfg, x).float(), cache
