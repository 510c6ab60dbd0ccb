"""qwen1.5-110b — dense decoder LM with QKV bias [hf:Qwen/Qwen1.5-0.5B];
a copy of the reference's ``repro.configs`` entry.

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=49152, vocab 152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    parallel_mode="sp",
    subquadratic=False,
    # bf16 AdamW moments beside f32 master weights: the reference's choice
    # for its sharded training run (the port's dense training: ROADMAP
    # queue 1 item 9g).
    opt_dtype="bfloat16",
)
