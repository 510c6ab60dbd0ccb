"""whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356];
a copy of the reference's ``repro.configs`` entry.

4L enc + 4L dec, d_model=384, 6 heads (kv=6), d_ff=1536, vocab 51865.
The conv audio frontend is a STUB: ``input_specs`` provides precomputed
frame embeddings (B, 1500, 384) per the brief. GeLU MLP, LayerNorm,
learned positions (we use RoPE-free sinusoidal-equivalent: plain learned
table folded into the stub embeddings for the encoder; decoder uses RoPE
for simplicity of the shared stack — noted in DESIGN.md §7).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    mlp="gelu",
    norm="layernorm",
    encoder_layers=4,
    encoder_seq=1504,  # 1500 audio frames padded to a multiple of 16
    parallel_mode="sp",
    subquadratic=False,
)
