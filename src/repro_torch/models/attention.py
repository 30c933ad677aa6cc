"""Attention: GQA (prefill on the flash kernel, KV-cache decode on a
chunked online-softmax scan) and MLA (deepseek's latent attention).

Counterpart of ``repro.models.attention``.  GQA prefill attention
(``attention_dispatch``) always goes through ``kernels.ops.flash_attention``:
the CUDA kernel for a CUDA tensor, the plain version on the CPU or with
``backend="torch"``.  Single-token decode attends over the cache with
``chunked_attention``, plain PyTorch, as the reference's decode is a
``lax.scan`` with no kernel.  MLA attends over its latent with
``chunked_attention`` in float32, prefill and decode alike, as the
reference's MLA does (it never calls ``attention_dispatch``).  Sequence
parallelism and the mesh runtime are not ported (ROADMAP.md Queue 1).

A block's parameters are an ``nn.ParameterDict`` with the reference's
names and layouts: weights ``(d_in, d_out)``, biases ``(d_out,)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -1.0e30


def chunked_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool,
    chunk: int,
    q_offset: int = 0,
    kv_valid_len: Optional[int] = None,
) -> Tensor:
    """Online-softmax attention, scanning KV in chunks (float32 inside).

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D).  ``q_offset`` is the absolute
    position of q[..., 0, :] (for causal masking during cached decode);
    ``kv_valid_len`` masks trailing (unwritten) cache positions.  Both are
    host ints (the engine's clock lives on the host), so the masks cost no
    host-to-device copy.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = 1.0 / (d ** 0.5)
    dev = q.device

    chunk = min(chunk, sk)
    if sk % chunk:  # pad KV to a chunk multiple, mask the tail
        pad = (-sk) % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if kv_valid_len is None:
            kv_valid_len = sk
        sk += pad
    n_chunks = sk // chunk

    qf = (q.float() * scale).reshape(b, hkv, group, sq, d)
    q_pos = torch.arange(sq, device=dev) + q_offset
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, group, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        kb = k[:, :, idx * chunk:(idx + 1) * chunk].float()
        vb = v[:, :, idx * chunk:(idx + 1) * chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        k_pos = idx * chunk + torch.arange(chunk, device=dev)
        if causal:
            s = torch.where((q_pos[:, None] >= k_pos[None, :]), s, NEG_INF)
        if kv_valid_len is not None:
            s = torch.where(k_pos < kv_valid_len, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attention_dispatch(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool, backend: Optional[str] = None
) -> Tensor:
    """Prefill attention: every call goes to ``kops.flash_attention`` (the
    CUDA kernel for a CUDA tensor, whatever the length; no fallback)."""
    return kops.flash_attention(q, k, v, causal=causal, backend=backend)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> nn.ParameterDict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": L.dense_init(gen, d, hq * hd, dtype),
        "wk": L.dense_init(gen, d, hkv * hd, dtype),
        "wv": L.dense_init(gen, d, hkv * hd, dtype),
        "wo": L.dense_init(gen, hq * hd, d, dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return nn.ParameterDict({name: L.frozen(t) for name, t in p.items()})


def gqa_project_qkv(
    p, x: Tensor, cfg: ModelConfig, positions: Tensor, *, rope: bool = True
) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, D) -> contiguous q (B, Hq, S, hd), k and v (B, Hkv, S, hd)."""
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if rope:
        q = L.apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = L.apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_attn(
    p, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
    positions: Optional[Tensor] = None, rope: bool = True, backend: Optional[str] = None,
) -> Tensor:
    """Full-sequence GQA attention (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = gqa_project_qkv(p, x, cfg, positions, rope=rope)
    out = attention_dispatch(q, k, v, causal=causal, backend=backend)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"]


def gqa_decode(
    p, x: Tensor, cfg: ModelConfig, k_cache: Tensor, v_cache: Tensor, t: int,
    *, rope: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode: write position ``t`` of the cache, attend over it.

    x: (B, 1, D); caches: (B, Hkv, S_max, hd), updated in place (the
    reference returns new arrays; writing in place saves a cache copy per
    layer and step) and returned.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), t, dtype=torch.int64, device=x.device)
    q, k_new, v_new = gqa_project_qkv(p, x, cfg, positions, rope=rope)
    k_cache[:, :, t:t + 1] = k_new
    v_cache[:, :, t:t + 1] = v_new
    out = chunked_attention(
        q, k_cache, v_cache, causal=False, chunk=cfg.attn_chunk,
        q_offset=t, kv_valid_len=t + 1,
    )
    out = out.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, deepseek-v2)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> nn.ParameterDict:
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.mla_kv_lora_rank
    dn, dr, dv = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim, cfg.mla_v_head_dim
    p = {
        # queries: full-rank (v2-lite has no q compression)
        "wq": L.dense_init(gen, d, h * (dn + dr), dtype),
        # kv down-projection to the latent + the shared rope key
        "wkv_a": L.dense_init(gen, d, r + dr, dtype),
        "kv_norm": torch.ones((r,), dtype=dtype, device=gen.device),
        # latent up-projection to per-head nope-key and value
        "wkv_b": L.dense_init(gen, r, h * (dn + dv), dtype),
        "wo": L.dense_init(gen, h * dv, d, dtype),
    }
    return nn.ParameterDict({name: L.frozen(t) for name, t in p.items()})


def _mla_qkv(p, x: Tensor, cfg: ModelConfig, positions: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """x (B, S, D) -> q_nope (B, H, S, dn), q_rope (B, H, S, dr), the
    normed latent c_kv (B, S, r) and the shared rope key (B, 1, S, dr)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim
    r = cfg.mla_kv_lora_rank

    q = (x @ p["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(q_rope.transpose(1, 2), positions[:, None, :], cfg.rope_theta)

    kv = x @ p["wkv_a"]                      # (B, S, r + dr)
    c_kv = L.rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., r:][:, None], positions[:, None, :], cfg.rope_theta)
    return q_nope.transpose(1, 2), q_rope, c_kv, k_rope


def _mla_qcomb(p, q_nope: Tensor, q_rope: Tensor, cfg: ModelConfig) -> Tensor:
    """Absorbed query in latent space, pre-scaled: (B, H, Sq, r + dr) float32."""
    b, h, sq, dn = q_nope.shape
    r = cfg.mla_kv_lora_rank
    wk = p["wkv_b"].reshape(r, h, dn + cfg.mla_v_head_dim)[..., :dn]
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope.float(), wk.float())
    q_comb = torch.cat([q_lat, q_rope.float()], dim=-1)
    scale = 1.0 / ((dn + cfg.mla_rope_head_dim) ** 0.5)
    comp = (q_comb.shape[-1] ** 0.5) * scale  # net scale inside the scan = scale
    return q_comb * comp


def _mla_out(p, out_lat: Tensor, cfg: ModelConfig) -> Tensor:
    """Project the attended latent (B, H, Sq, r) to the model dim, in float32,
    cast to the weights' dtype."""
    b, h, sq, r = out_lat.shape
    dn, dv = cfg.mla_nope_head_dim, cfg.mla_v_head_dim
    wv = p["wkv_b"].reshape(r, h, dn + dv)[..., dn:]
    out = torch.einsum("bhqr,rhd->bhqd", out_lat.float(), wv.float())
    out = out.transpose(1, 2).reshape(b, sq, h * dv)
    return (out @ p["wo"].float()).to(p["wo"].dtype)


def _mla_attend(
    p, q_nope: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor, cfg: ModelConfig, *,
    causal: bool, q_offset: int = 0, kv_valid_len: Optional[int] = None,
) -> Tensor:
    """Attention over the latent: the absorbed query (dim r + dr) against
    the key ``[c_kv, k_rope]`` and the value ``[c_kv, 0]`` of one shared
    head, by the plain ``chunked_attention`` in float32 (the reference's
    MLA reaches no kernel); the attended latent is the first r columns.

    q_nope: (B, H, Sq, dn), q_rope: (B, H, Sq, dr), c_kv: (B, Sk, r),
    k_rope: (B, 1, Sk, dr)."""
    r = cfg.mla_kv_lora_rank
    q_comb = _mla_qcomb(p, q_nope, q_rope, cfg)
    keys = torch.cat([c_kv, k_rope[:, 0]], dim=-1)[:, None].float()          # (B, 1, Sk, r + dr)
    values = torch.cat([c_kv, torch.zeros_like(k_rope[:, 0])], dim=-1)[:, None].float()
    out_lat = chunked_attention(
        q_comb, keys, values, causal=causal, chunk=cfg.attn_chunk,
        q_offset=q_offset, kv_valid_len=kv_valid_len,
    )
    return _mla_out(p, out_lat[..., :r], cfg)


def mla_attn(p, x: Tensor, cfg: ModelConfig, *, causal: bool = True) -> Tensor:
    """Full-sequence MLA attention (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    return _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, causal=causal)


def mla_decode(
    p, x: Tensor, cfg: ModelConfig, ckv_cache: Tensor, krope_cache: Tensor, t: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Decode with the compressed latent cache: write position ``t`` in
    place and attend over it.  ckv_cache: (B, S_max, r); krope_cache:
    (B, 1, S_max, dr)."""
    b = x.shape[0]
    positions = torch.full((b, 1), t, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(p, x, cfg, positions)
    ckv_cache[:, t:t + 1] = c_new
    krope_cache[:, :, t:t + 1] = kr_new
    out = _mla_attend(
        p, q_nope, q_rope, ckv_cache, krope_cache, cfg,
        causal=False, q_offset=t, kv_valid_len=t + 1,
    )
    return out, ckv_cache, krope_cache
