"""Streamed dark→bright candidate selection (replaces the TPU z_update kernel)."""
