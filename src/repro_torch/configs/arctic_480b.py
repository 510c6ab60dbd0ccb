"""arctic-480b — dense+MoE hybrid, 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]; a copy of the reference's
``repro.configs`` entry.

35L, d_model=7168, 56 heads (GQA kv=8), d_ff=4864, vocab 32000.
Every layer runs a dense FFN residual path in parallel with the MoE.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(
        n_experts=128, top_k=2, capacity_factor=1.25, dense_residual=True
    ),
    parallel_mode="sp",
    subquadratic=False,
    # 480B params × 12 B/param of f32 AdamW state does not fit 256×16 GB;
    # bf16 moments bring resident state to 8 B/param (EXPERIMENTS §Dry-run).
    opt_dtype="bfloat16",
)
