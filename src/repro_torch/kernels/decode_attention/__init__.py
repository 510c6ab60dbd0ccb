"""Flash-decode of one token over a ring KV cache (``csrc/decode_attention.cu``)."""
