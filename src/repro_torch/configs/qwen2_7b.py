"""qwen2-7b — dense decoder LM, GQA, QKV bias [arXiv:2407.10671];
a copy of the reference's ``repro.configs`` entry.

28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab 152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    parallel_mode="sp",
    subquadratic=False,
)
