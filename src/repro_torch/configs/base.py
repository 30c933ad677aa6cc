"""Architecture configuration schema + the assigned input-shape grid.

A copy of ``repro.configs.base`` (plain dataclasses, no JAX), so that the
port needs nothing of the JAX package.

One ``ModelConfig`` per assigned architecture lives in
``repro/configs/<id>.py``; reduced variants (``.reduced()``) power the CPU
smoke tests.  Input shapes follow the assignment:

    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (serve prefill)
    decode_32k   seq 32768,  global_batch 128   (serve decode, 1 new token)
    long_500k    seq 524288, global_batch 1     (long-context decode)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6

    # --- MoE ---------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim
    moe_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    dense_d_ff_first: int = 0    # deepseek: first layer is a dense MLP

    # --- MLA (deepseek) ----------------------------------------------------
    mla_kv_lora_rank: int = 0
    mla_rope_head_dim: int = 0
    mla_nope_head_dim: int = 0
    mla_v_head_dim: int = 0

    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # --- hybrid (zamba2) -----------------------------------------------------
    hybrid_attn_every: int = 0   # shared attention block applied every k layers

    # --- encoder-decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0         # precomputed frame embeddings (conv stub)

    # --- VLM (llava) ----------------------------------------------------------
    vision_patches: int = 0      # patch embeddings replacing the prompt prefix

    # --- limits ----------------------------------------------------------------
    max_seq: int = 32_768        # learned-position table size (encdec only)

    # --- numerics / memory ----------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "dots"   # none | dots | full
    logit_chunk: int = 2048      # sequence chunking for the xent loss
    attn_chunk: int = 1024       # KV chunking for memory-efficient attention

    # shapes this arch cannot run, with reasons (DESIGN.md §5)
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp = 3 * d * f
            per_layer = attn + mlp
            total = emb + self.n_layers * per_layer
            if self.family == "encdec":
                total += self.encoder_layers * (2 * attn + mlp)  # self+cross approx
            return total
        if self.family in ("moe", "mla_moe"):
            if self.family == "mla_moe":
                r = self.mla_kv_lora_rank
                qd = self.n_heads * (self.mla_nope_head_dim + self.mla_rope_head_dim)
                attn = d * qd + d * (r + self.mla_rope_head_dim) \
                    + r * self.n_heads * (self.mla_nope_head_dim + self.mla_v_head_dim) \
                    + self.n_heads * self.mla_v_head_dim * d
            else:
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            experts = 3 * d * self.moe_d_ff * (self.moe_num_experts + self.moe_shared_experts)
            router = d * self.moe_num_experts
            return emb + self.n_layers * (attn + experts + router)
        if self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            per_layer = d * (2 * di + 2 * self.ssm_groups * n + self.ssm_heads) \
                + di * d + self.ssm_conv * (di + 2 * self.ssm_groups * n)
            return emb + self.n_layers * per_layer
        if self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * self.ssm_groups * n + self.ssm_heads) + di * d
            shared_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d + 3 * d * self.d_ff
            return emb + self.n_layers * mamba + shared_attn
        raise ValueError(self.family)

    def active_params(self) -> int:
        """Active (per-token) parameters — MoE counts top_k+shared experts."""
        if self.family not in ("moe", "mla_moe"):
            return self.n_params()
        full_experts = self.moe_num_experts
        active_experts = self.moe_top_k + self.moe_shared_experts
        expert_params = 3 * self.d_model * self.moe_d_ff
        return self.n_params() - (full_experts + self.moe_shared_experts - active_experts) * expert_params * self.n_layers

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            max_detail_unchanged=None,
        )
        kw.pop("max_detail_unchanged")
        if self.moe_num_experts:
            kw.update(moe_num_experts=4, moe_top_k=2, moe_d_ff=64,
                      moe_shared_experts=min(self.moe_shared_experts, 1))
        if self.dense_d_ff_first:
            kw.update(dense_d_ff_first=128)
        if self.mla_kv_lora_rank:
            kw.update(mla_kv_lora_rank=32, mla_rope_head_dim=8,
                      mla_nope_head_dim=16, mla_v_head_dim=16)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.hybrid_attn_every:
            kw.update(hybrid_attn_every=2, n_layers=4)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=16)
        if self.vision_patches:
            kw.update(vision_patches=8)
        kw.update(param_dtype="float32", compute_dtype="float32",
                  logit_chunk=32, attn_chunk=32, max_seq=64)
        return replace(self, **kw)
