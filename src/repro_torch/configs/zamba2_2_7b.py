"""zamba2-2.7b — hybrid Mamba2 + shared attention block [arXiv:2411.15242; hf].

54 mamba layers d_model=2560, ssm_state=64; a weight-shared (attention +
MLP) block (32H, d_ff=10240) applied every 6 mamba layers.  vocab=32000.
Runs ALL shapes including long_500k (SSM state + small shared-attn KV).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    tie_embeddings=True,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    hybrid_attn_every=6,
)
