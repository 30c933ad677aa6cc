"""Roofline terms of a counted step, on one NVIDIA H100 per rank.

Counterpart of ``repro.launch.roofline``, with the card's figures
(``launch.mesh``) in place of the TPU v5e's.  Three terms per (arch x
shape x mesh), in seconds:

    compute    = flops_per_chip      / PEAK_FLOPS_BF16 (the tensor cores)
    memory     = hbm_bytes (flash)   / HBM_BW
    collective = sum over mesh axes of that axis's bytes / its bandwidth

The counts come from ``launch.op_cost`` run on one rank's step
(``launch.dryrun``), so they are per chip already.  A collective's
bandwidth is its axis's: NVLink where the axis's groups stay inside a node
of 8, InfiniBand where they cross nodes (``mesh.axis_bandwidth``); bytes
with no axis (the reference's inputs) go at the InfiniBand rate.

``memory_s`` is the reference's "kernelized" term: the plain attention's
bytes (``flash_bytes``) replaced by the flash kernel's own traffic
(``analytic_flash_traffic``, K/V read once per q tile of the port's
kernel, ``BQ = 64``).  On the card the port runs that kernel in the
forward pass only; the backward recomputes the plain version
(``kernels.ops.FlashAttention``), and decode and MLA attention are plain,
so for those ``memory_portable_s`` is nearer what the card moves.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, IB_BW, PEAK_FLOPS_BF16, axis_bandwidth

#: Query rows a CTA of the flash kernel holds (``kernels/csrc/flash_attention.cu``, BQ).
FLASH_BLOCK_Q = 64


def analytic_flash_traffic(
    cfg, shape, mesh_shape: Dict[str, int], kind: str, *, block_q: int = FLASH_BLOCK_Q
) -> float:
    """Per-chip HBM bytes of a kernelized attention (the probabilities stay
    on chip): q read and out written once, K/V streamed once per q tile of
    ``block_q`` rows; the SSD families' stream, states spilled once per
    chunk.  The reference's formula, term for term (bf16, fwd + remat
    recompute + bwd for training)."""
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_shape.get(a, 1)
    m = mesh_shape.get("model", 1)
    b_loc = max(shape.global_batch // dp, 1)
    dt = 2  # bf16

    def call_bytes(sq: int, sk: int, hq: int, hkv: int, hd: int, hd_v: int) -> float:
        hq_loc = max(hq // m, 1)
        q_out = 2.0 * b_loc * sq * hq_loc * max(hd, hd_v) * dt
        n_tiles = max(-(-sq // block_q), 1)
        kv = n_tiles * b_loc * sk * hkv * (hd + hd_v) * dt
        return q_out + kv

    def ssd_bytes(sq_: int) -> float:
        if not cfg.ssm_state:
            return 0.0
        di, n, g, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
        ph = cfg.ssm_head_dim
        width = 2 * di + 2 * g * n + h           # zxbcdt stream
        nc = max(sq_ // max(cfg.ssm_chunk, 1), 1)
        io = b_loc * sq_ * (width + di) * dt
        states = nc * b_loc * h * n * ph * 4     # fp32 inter-chunk states
        return io + states

    fam = cfg.family
    mult = 3.0 if kind == "train" else 1.0
    s = shape.seq_len
    if kind == "decode":
        mult, sq = 1.0, 1
    else:
        sq = s

    if fam in ("dense", "moe", "vlm"):
        per = call_bytes(sq, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
        return mult * cfg.n_layers * per
    if fam == "mla_moe":
        r = cfg.mla_kv_lora_rank + cfg.mla_rope_head_dim
        per = call_bytes(sq, s, cfg.n_heads, 1, r, r)
        return mult * cfg.n_layers * per
    if fam == "encdec":
        dec_self = call_bytes(sq, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
        cross = call_bytes(sq, cfg.encoder_seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
        enc = (
            call_bytes(cfg.encoder_seq, cfg.encoder_seq, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
            if kind != "decode" else 0.0
        )
        return mult * (cfg.n_layers * (dec_self + cross) + cfg.encoder_layers * enc)
    if fam == "hybrid":
        n_apps = max(cfg.n_layers // max(cfg.hybrid_attn_every, 1), 1)
        attn = n_apps * call_bytes(sq, s, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.head_dim)
        return mult * (attn + cfg.n_layers * ssd_bytes(sq))
    if fam == "ssm":
        return mult * cfg.n_layers * ssd_bytes(sq)
    return 0.0


@dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    n_chips: int
    model_flops: float                  # 6ND train / 2ND inference (global)
    flash_bytes_per_chip: float = 0.0   # plain-attention HBM subset
    kernel_flash_bytes: float = 0.0     # the kernel's analytic traffic, substituted
    coll_bytes_by_axis: Dict[str, float] = field(default_factory=dict)  # same bytes, by mesh axis
    mesh_shape: Dict[str, int] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def memory_portable_s(self) -> float:
        """HBM term of the eager step as counted (plain attention in HBM)."""
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def hbm_bytes_kernelized(self) -> float:
        """HBM bytes with the plain attention's replaced by the kernel's
        analytic traffic, capped at the counted bytes (a kernel never adds
        traffic)."""
        return min(
            self.hbm_bytes_per_chip
            - self.flash_bytes_per_chip
            + self.kernel_flash_bytes,
            self.hbm_bytes_per_chip,
        )

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_kernelized / HBM_BW

    @property
    def collective_s(self) -> float:
        if not self.coll_bytes_by_axis:
            return self.coll_bytes_per_chip / IB_BW
        world = {"world": self.n_chips}
        return sum(b / axis_bandwidth(self.mesh_shape if a in self.mesh_shape else world, a)
                   for a, b in self.coll_bytes_by_axis.items())

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Step-time floor: the largest of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops of every chip: the remat and
        redundancy waste (a model axis that computes the same rows on each
        of its ranks divides it by the axis's size)."""
        total = self.flops_per_chip * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.n_chips * PEAK_FLOPS_BF16 * self.step_s
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "flash_bytes_per_chip": self.flash_bytes_per_chip,
            "kernel_flash_bytes": self.kernel_flash_bytes,
            "hbm_bytes_kernelized": self.hbm_bytes_kernelized,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_portable_s": self.memory_portable_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops_for(kind: str, n_params: int, n_active: int, tokens: int) -> float:
    """6ND for training (fwd+bwd), 2ND for inference; MoE uses active N."""
    return (6.0 if kind == "train" else 2.0) * n_active * tokens

