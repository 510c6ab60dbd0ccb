"""mixtral-8x7b — MoE decoder LM, 8 experts top-2, SWA [arXiv:2401.04088];
a copy of the reference's ``repro.configs`` entry.

32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=14336, vocab 32000.
Sliding-window attention (4096) gives a bounded KV cache, so this arch
runs the long_500k shape (DESIGN.md §4).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    swa_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    parallel_mode="sp",
    subquadratic=True,  # SWA: O(window) cache
)
