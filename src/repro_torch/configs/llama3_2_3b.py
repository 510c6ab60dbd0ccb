"""llama3.2-3b — small llama3 dense decoder LM [hf:meta-llama/Llama-3.2-1B];
a copy of the reference's ``repro.configs`` entry.

28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab 128256.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    parallel_mode="sp",
    subquadratic=False,
)
