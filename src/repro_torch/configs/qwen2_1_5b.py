"""qwen2-1.5b — dense GQA decoder with QKV bias [arXiv:2407.10671; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; tied embeddings.
long_500k skipped: pure full attention (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
)
