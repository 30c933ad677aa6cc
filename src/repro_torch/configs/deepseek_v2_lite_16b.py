"""deepseek-v2-lite-16b — MLA + MoE decoder [arXiv:2405.04434; hf].

27L d_model=2048 16H, MLA kv_lora=512 (rope 64 / nope 128 / v 128),
MoE 64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer
dense (d_ff=10944), vocab=102400.

Note: the assignment line lists both "64e top-6" and "160 routed" (the
latter is full v2); v2-LITE has 64 routed experts — we implement 64,
matching the published lite config and the assignment's [moe] summary.
long_500k skipped: MLA is still full (latent) attention (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,            # = expert hidden dim, per assignment
    vocab_size=102400,
    head_dim=192,          # nope 128 + rope 64
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_shared_experts=2,
    dense_d_ff_first=10944,
    mla_kv_lora_rank=512,
    mla_rope_head_dim=64,
    mla_nope_head_dim=128,
    mla_v_head_dim=128,
    rope_theta=10_000.0,
    skip_shapes=("long_500k",),
)
