"""GQA attention: the prefill path on the flash kernel, the KV-cache decode
path on a chunked online-softmax scan.

Counterpart of ``repro.models.attention`` for the dense family.  Prefill
attention (``attention_dispatch``) always goes through
``kernels.ops.flash_attention``: the CUDA kernel for a CUDA tensor, the
plain version on the CPU or with ``backend="torch"``.  Single-token decode
attends over the cache with ``chunked_attention``, plain PyTorch, as the
reference's decode is a ``lax.scan`` with no kernel.  MLA, sequence
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
