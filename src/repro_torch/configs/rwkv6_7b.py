"""rwkv6-7b ("Finch") — attention-free RNN with data-dependent decay
[arXiv:2404.05892]; a copy of the reference's ``repro.configs`` entry.

32L, d_model=4096 (64 heads × 64 head-dim time-mixing), d_ff=14336 (the
channel mix's width), vocab 65536, untied embeddings. The blocks have no
MLP: the dataclass default ``mlp="swiglu"`` is unused.
"""

from repro_torch.models.config import ModelConfig

# Σ numel of the port's model at this config (no MLP in the blocks): 7.526 B
N_PARAMS = 7_525_896_192

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # WKV heads (head_dim 64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    parallel_mode="tp",
    subquadratic=True,
)
