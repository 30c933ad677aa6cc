"""Mamba2 (SSD, state-space duality) blocks.

Counterpart of ``repro.models.ssm``: the chunked SSD algorithm (Dao & Gu
2024) for a whole sequence and the O(1) recurrent step for decode.  Inside
a chunk the work is dense (q x q) attention-like einsums; across chunks
the state recurrence ``S_k = decay_k * S_{k-1} + states_k`` runs either as
a sequential loop over the chunks carrying the state (``"scan"``, the
reference's ``lax.scan``; prefill's form) or as a log-depth doubling scan
over the chunk axis with the affine combine ``(a1·a2, s1·a2 + s2)``
(``"assoc"``, the paper's Scan DPP at the LM layer).

No kernel: the reference's SSD reaches no ``pl.pallas_call`` (its "fused
TPU SSD kernel" is a named scope), so this is plain PyTorch on every
device.  The rounding points are the reference's: the depthwise conv sums
in float32 and casts back to the input dtype; x, B and C go to float32
for the recurrence; ``y`` is cast to the input dtype before the gated RMS
norm; ``in_proj`` and ``out_proj`` run in the compute dtype; ``a_log``,
``dt_bias`` and ``d_skip`` are float32 whatever ``param_dtype`` is.

A block's parameters are an ``nn.ParameterDict`` with the reference's
names and layouts.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Tensor = torch.Tensor
NEG_INF = -1.0e30
FLOAT32_PARAMS = ("a_log", "dt_bias", "d_skip")
INTER_CHUNK = ("scan", "assoc")


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> nn.ParameterDict:
    d, di, n, g, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen, device=dev, dtype=torch.float32) * 0.1
    p = {
        # projection to (z, x, B, C, dt)
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * g * n + h, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, di, d, dtype),
    }
    return nn.ParameterDict({name: L.frozen(t) for name, t in p.items()})


def _split_proj(cfg: ModelConfig, zxbcdt: Tensor):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + g * n]
    c = zxbcdt[..., 2 * di + g * n:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, x, b, c, dt


def _causal_conv(xbc: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C): the taps
    summed in float32 in order, SiLU, cast back to ``xbc``'s dtype."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return F.silu(out + bias.float()).to(xbc.dtype)


def _chunk_intra(cc: Tensor, bc_: Tensor, xc: Tensor, dac: Tensor, dtc: Tensor, s_prev: Tensor):
    """One chunk's SSD given the entering state.

    cc/bc_: (B, q, H, N); xc: (B, q, H, P); dac/dtc: (B, q, H); s_prev:
    (B, H, N, P).  Returns (y_chunk (B, q, H, P), new_state, chunk_decay
    (B, H))."""
    q = cc.shape[1]
    cum = torch.cumsum(dac, dim=1)                          # (B, q, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]           # (B, q, q, H)
    lmask = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    # mask BEFORE exp: exp of the upper triangle overflows, and inf * 0 is NaN
    ldecay = torch.exp(torch.where(lmask[None, :, :, None], seg, NEG_INF))

    scores = torch.einsum("bihd,bjhd->bijh", cc, bc_) * ldecay
    y_diag = torch.einsum("bijh,bjh,bjhp->bihp", scores, dtc, xc)

    decay_to_end = torch.exp(cum[:, -1:, :] - cum)          # (B, q, H)
    states = torch.einsum("bjh,bjh,bjhd,bjhp->bhdp", decay_to_end, dtc, bc_, xc)
    chunk_decay = torch.exp(torch.sum(dac, dim=1))          # (B, H)

    decay_from_start = torch.exp(cum)                       # (B, q, H)
    y_off = torch.einsum("bihd,bih,bhdp->bihp", cc, decay_from_start, s_prev)

    new_state = s_prev * chunk_decay[..., None, None] + states
    return y_diag + y_off, new_state, chunk_decay


def _assoc_scan(decay: Tensor, states: Tensor) -> Tensor:
    """Inclusive scan over the leading (chunk) axis of the affine maps
    ``S -> decay_k * S + states_k``, by log-depth doubling: at each round
    every chunk k >= off combines with chunk k - off,
    ``(a1, s1), (a2, s2) -> (a1 * a2, s1 * a2 + s2)``.  decay: (nc, B, H);
    states: (nc, B, H, N, P).  Returns the states S_k (nc, B, H, N, P)."""
    a, s = decay, states
    off, nc = 1, decay.shape[0]
    while off < nc:
        a2, s2 = a[off:], s[off:]
        a = torch.cat([a[:off], a[:-off] * a2])
        s = torch.cat([s[:off], s[:-off] * a2[..., None, None] + s2])
        off *= 2
    return s


def ssd_forward(
    p, x_in: Tensor, cfg: ModelConfig, *, inter_chunk: str = "scan", return_state: bool = False,
):
    """Full-sequence SSD.  x_in: (B, S, d_model) -> (B, S, d_model).

    ``inter_chunk`` is ``"scan"`` (a loop over the chunks carrying the
    state: one (B, q, q, H) buffer live at a time) or ``"assoc"`` (every
    chunk's intra-chunk pass at once, then ``_assoc_scan`` over the
    chunks).  The chunk length is ``q = min(cfg.ssm_chunk, S)`` and S
    must be a multiple of it, else :class:`ValueError` (padding would
    change the final state and the conv ring).

    ``return_state=True`` also returns the decode-ready states: the conv
    ring (B, K-1, conv_dim), the last K-1 pre-conv inputs zero-padded in
    front when S < K-1, and the SSM state (B, H, N, P) float32."""
    if inter_chunk not in INTER_CHUNK:
        raise ValueError(f"unknown inter_chunk {inter_chunk!r}; have {INTER_CHUNK}")
    bsz, s, _ = x_in.shape
    di, n, g, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    if s < 1 or s % q:
        raise ValueError(f"SSD needs a sequence length that is a multiple of the chunk "
                         f"min({cfg.ssm_chunk}, S); got S = {s}")
    nc = s // q

    zxbcdt = x_in @ p["in_proj"]
    z, x, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([x, b, c], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x, b, c = xbc[..., :di], xbc[..., di:di + g * n], xbc[..., di + g * n:]

    # heads, in float32 through the recurrence
    x = x.reshape(bsz, s, h, ph).float()
    rep = h // g
    b = b.reshape(bsz, s, g, n).float().repeat_interleave(rep, dim=2)   # (B, S, H, N)
    c = c.reshape(bsz, s, g, n).float().repeat_interleave(rep, dim=2)

    dt = F.softplus(dt.float() + p["dt_bias"])             # (B, S, H)
    a = -torch.exp(p["a_log"])                              # (H,)
    da = dt * a                                             # (B, S, H) log-decay

    def chunk(t):  # (B, S, ...) -> (nc, B, q, ...)
        return t.reshape(bsz, nc, q, *t.shape[2:]).transpose(0, 1)

    xc, bc_, cc, dac, dtc = (chunk(t) for t in (x, b, c, da, dt))

    if inter_chunk == "scan":
        state = torch.zeros((bsz, h, n, ph), dtype=torch.float32, device=x_in.device)
        ys = []
        for i in range(nc):
            y_i, state, _ = _chunk_intra(cc[i], bc_[i], xc[i], dac[i], dtc[i], state)
            ys.append(y_i)
        y = torch.stack(ys, dim=1).reshape(bsz, s, h, ph)
    else:
        # every chunk's intra pass from a zero state, the chunks on the batch axis ...
        flat = lambda t: t.reshape(nc * bsz, *t.shape[2:])
        zero = torch.zeros((nc * bsz, h, n, ph), dtype=torch.float32, device=x_in.device)
        y_diag, states, chunk_decay = _chunk_intra(*(flat(t) for t in (cc, bc_, xc, dac, dtc)), zero)
        unflat = lambda t: t.reshape(nc, bsz, *t.shape[1:])
        # ... then the inter-chunk affine recurrence by the Scan DPP
        s_inc = _assoc_scan(unflat(chunk_decay), unflat(states))
        s_prev = torch.cat([torch.zeros_like(s_inc[:1]), s_inc[:-1]])
        cum = torch.cumsum(dac, dim=2)                      # (nc, B, q, H)
        y_off = torch.einsum("nbihd,nbih,nbhdp->nbihp", cc, torch.exp(cum), s_prev)
        y = (unflat(y_diag) + y_off).transpose(0, 1).reshape(bsz, s, h, ph)
        state = s_inc[-1]

    y = y + x * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di)

    # gated RMS norm, out projection
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x_in.dtype), p["out_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    kk = cfg.ssm_conv
    pad = torch.zeros((bsz, max(kk - 1 - s, 0), xbc_raw.shape[-1]), dtype=xbc_raw.dtype, device=x_in.device)
    conv_state = torch.cat([pad, xbc_raw[:, max(s - (kk - 1), 0):]], dim=1)
    return out, conv_state, state


def ssd_decode(
    p, x_in: Tensor, cfg: ModelConfig, conv_state: Tensor, ssm_state: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token recurrent step.  x_in: (B, 1, d_model); conv_state:
    (B, K-1, conv_dim); ssm_state: (B, H, N, P).  Returns the output and
    new states (the inputs are not written)."""
    bsz = x_in.shape[0]
    di, n, g, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x_in @ p["in_proj"]
    z, x, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, b, c], dim=-1)[:, 0]                # (B, conv_dim)

    # the conv ring
    window = torch.cat([conv_state, xbc[:, None]], dim=1)   # (B, K, conv_dim)
    conv_state = window[:, 1:]
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())

    x = conv_out[:, :di].reshape(bsz, h, ph)
    rep = h // g
    b = conv_out[:, di:di + g * n].reshape(bsz, g, n).repeat_interleave(rep, dim=1)   # (B, H, N)
    c = conv_out[:, di + g * n:].reshape(bsz, g, n).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])        # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                               # (B, H)

    # S = decay S + dt * B x^T
    upd = torch.einsum("bh,bhd,bhp->bhdp", dt, b, x)
    ssm_state = ssm_state * decay[..., None, None] + upd
    y = torch.einsum("bhd,bhdp->bhp", c, ssm_state)         # (B, H, P)
    y = y + x * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di)

    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x_in.dtype), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"], conv_state, ssm_state
