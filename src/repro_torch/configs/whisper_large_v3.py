"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356;
unverified].

32L (enc+dec) d_model=1280 20H d_ff=5120 vocab=51866; conv frontend is a
STUB — input_specs supplies precomputed frame embeddings (B, 1500, D).
long_500k skipped: full attention decoder (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    encoder_layers=32,
    encoder_seq=1500,
    max_seq=32768,  # backbone exercised at assigned shapes (>448 audio cap)
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
