"""mamba2-130m — pure-SSM (SSD) LM [arXiv:2405.21060; unverified].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128, headdim 64,
expand 2.  Runs ALL shapes including long_500k (O(1)-state decode).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
)
