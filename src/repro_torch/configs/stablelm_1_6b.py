"""stablelm-1.6b — dense decoder LM [hf:stabilityai/stablelm-2-1_6b];
a copy of the reference's ``repro.configs`` entry.

24L, d_model=2048, 32 heads (MHA: kv=32), d_ff=5632, vocab 100352.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    parallel_mode="sp",
    subquadratic=False,
)
