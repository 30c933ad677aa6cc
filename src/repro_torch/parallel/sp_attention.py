"""Sequence-parallel cached-decode attention (flash combine across shards).

Counterpart of ``repro.parallel.sp_attention``.  At long context the KV
cache dominates device memory, so its sequence dim is split over a mesh
axis (``parallel.sharding.cache_specs``: ``model``).  Decode attention
then needs a cross-shard softmax: each rank computes a float32
online-softmax partial (m, l, acc) over its local KV slice, and the
partials are merged with the flash rescaling identity

    m* = max(m),   l* = sum(l . e^{m-m*}),   acc* = sum(acc . e^{m-m*})

— one ``all_reduce(MAX)`` of m and one ``SUM`` of the buffer holding
l and acc, instead of all-gathering the cache.  The new token's K/V are
written by the owning rank only (position t falls in exactly one rank's
slice).  Lanes past t are zeroed after the exp, so a rank whose whole
slice lies past t counts nothing.

A rank holds plain local tensors: its rows of the batch (split over the
dp axes outside) and its slice of the cache, written in place.  Decode
carries no gradient.  Used by every cached-attention family (GQA, MLA,
whisper self-attention, the zamba shared block) through the runtime hook
in ``models.attention``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
NEG_INF = -1.0e30


def _local_flash(q: Tensor, k: Tensor, v: Tensor, start: int, t: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Partial online softmax over this rank's KV slice.

    q: (B, Hkv, G, 1, D) float32, pre-scaled; k/v: (B, Hkv, S_loc, D);
    start: global position of k[..., 0, :]; t: the current step (valid
    <= t).  Returns m (B, Hkv, G, 1, 1), l, acc (B, Hkv, G, 1, D)."""
    s_loc = k.shape[2]
    scores = torch.einsum("bhgqd,bhkd->bhgqk", q, k.float())
    valid = (start + torch.arange(s_loc, device=q.device)) <= t
    scores = torch.where(valid, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    # guard all-masked shards: exp(-1e30 - (-1e30)) = 1 lanes must not count
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return m, l, acc


def _combine(m: Tensor, l: Tensor, acc: Tensor, group) -> Tensor:
    """acc* / max(l*, 1e-30) over the group: one MAX, one SUM of [l, acc]."""
    import torch.distributed as dist

    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    buf = torch.cat([l * corr, acc * corr], dim=-1)
    dist.all_reduce(buf, group=group)
    return buf[..., 1:] / torch.clamp(buf[..., :1], min=1e-30)


def _owned(t: int, start: int, s_loc: int) -> bool:
    return start <= t < start + s_loc


def sp_decode_attention(
    q: Tensor,          # (B, Hq, 1, D)
    k_cache: Tensor,    # (B, Hkv, S_loc, D): this rank's slice of the sequence
    v_cache: Tensor,
    k_new: Tensor,      # (B, Hkv, 1, D)
    v_new: Tensor,
    t: int,             # write position / last valid position
    mesh,
    *,
    seq_axis: str = "model",
    batch_spec=None,    # the reference's batch entry; a rank's rows are local here
    scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (attn_out (B, Hq, 1, D), k_cache, v_cache), the caches
    written in place."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s_loc = k_cache.shape[2]
    start = mesh.get_local_rank(seq_axis) * s_loc
    t = int(t)
    if _owned(t, start, s_loc):
        k_cache[:, :, t - start] = k_new[:, :, 0]
        v_cache[:, :, t - start] = v_new[:, :, 0]
    qf = (q.float() * scale).reshape(b, hkv, hq // hkv, 1, d)
    out = _combine(*_local_flash(qf, k_cache, v_cache, start, t), mesh.get_group(seq_axis))
    return out.reshape(b, hq, 1, d).to(q.dtype), k_cache, v_cache


def sp_decode_attention_mla(
    q_comb: Tensor,       # (B, H, 1, r+dr): the pre-scaled absorbed query
    ckv_cache: Tensor,    # (B, S_loc, r): this rank's slice
    krope_cache: Tensor,  # (B, 1, S_loc, dr)
    c_new: Tensor,        # (B, 1, r)
    kr_new: Tensor,       # (B, 1, 1, dr)
    t: int,
    mesh,
    *,
    seq_axis: str = "model",
    batch_spec=None,
    scale: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """MLA latent-cache decode with the same flash combine.

    Keys are the local concat(latent, rope key), values the latent; the
    attended latent (B, H, 1, r) is returned for the wkv_b up-projection
    outside, with the caches written in place.  ``q_comb`` is
    ``attention._mla_qcomb``'s, pre-scaled for an attention that divides
    by sqrt(r + dr), as the single-device decode's ``chunked_attention``
    does; ``scale`` (default 1/sqrt(r + dr)) applies that division here.
    The reference's ``sp_decode_attention_mla`` leaves it out, so its
    scores are sqrt(r + dr) times its own single-device decode's; the port
    follows the single-device decode (its tests hold the two within the
    reference's SP bound)."""
    b, h, _, dcomb = q_comb.shape
    r = ckv_cache.shape[-1]
    s_loc = ckv_cache.shape[1]
    start = mesh.get_local_rank(seq_axis) * s_loc
    t = int(t)
    if _owned(t, start, s_loc):
        ckv_cache[:, t - start] = c_new[:, 0]
        krope_cache[:, :, t - start] = kr_new[:, :, 0]
    keys = torch.cat([ckv_cache, krope_cache[:, 0]], dim=-1)[:, None]   # (B, 1, S_loc, r+dr)
    if scale is None:
        scale = 1.0 / (dcomb ** 0.5)
    qf = (q_comb.float() * scale).reshape(b, 1, h, 1, dcomb)
    out = _combine(*_local_flash(qf, keys, ckv_cache[:, None], start, t), mesh.get_group(seq_axis))
    return out.reshape(b, h, 1, r).to(q_comb.dtype), ckv_cache, krope_cache
