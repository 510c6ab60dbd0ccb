"""Fused gather + δ + masked log L̃ sum (replaces the TPU bright_glm kernel)."""
