"""llava-next-mistral-7b — VLM: mistral-7b backbone + anyres patch tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf]; a copy of the reference's
``repro.configs`` entry.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab 32000.
The vision tower/anyres tiling is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, 576, d_model) occupying the leading
positions of the sequence (brief: frontend is a stub, backbone only).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    patch_positions=576,
    rope_theta=1_000_000.0,
    parallel_mode="sp",
    subquadratic=False,
)
