"""granite-3-8b — dense GQA decoder [hf:ibm-granite/granite-3.0 family; hf].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
long_500k skipped: pure full attention (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    rope_theta=10_000_000.0,
    skip_shapes=("long_500k",),
)
