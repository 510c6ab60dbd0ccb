"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1 attn : 2 rglru
[arXiv:2402.19427]; a copy of the reference's ``repro.configs``
entry.

38L (pattern rglru,rglru,attn — 26 recurrence + 12 local-attn layers; the
published 1:2 ratio rounded onto 38 layers), d_model=4096, 16 heads (MQA
kv=1, head dim 256), d_ff=12288, rnn width 4096, local window 2048, vocab
256000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    mlp="gelu",
    block_pattern=("rglru", "rglru", "attn"),
    local_attn_window=2048,
    rnn_width=4096,
    parallel_mode="tp",
    subquadratic=True,
)
