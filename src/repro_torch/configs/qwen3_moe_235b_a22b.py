"""qwen3-moe-235b-a22b — MoE decoder, 128 experts top-8
[hf:Qwen/Qwen3-235B-A22B family; hf].

94L d_model=4096 64H (GQA kv=4, head_dim 128) expert d_ff=1536 vocab=151936.
long_500k skipped: pure full attention (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,             # = expert hidden dim, per assignment
    vocab_size=151936,
    head_dim=128,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
)
