"""llava-next-34b — VLM: dense decoder backbone + anyres vision stub
[hf:llava-hf/llava-v1.6 family; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower
is a STUB: input_specs supplies precomputed patch embeddings (B, P, D)
(anyres tiles pre-flattened) that occupy the prompt prefix.
long_500k skipped: pure full attention (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    vision_patches=2880,   # 5 anyres tiles x 576 patches
    rope_theta=5_000_000.0,
    skip_shapes=("long_500k",),
)
