"""Fused softmax cross-entropy over a large vocabulary (``csrc/fused_ce.cu``)."""
