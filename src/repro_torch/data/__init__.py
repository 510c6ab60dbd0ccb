"""Synthetic GLM data for the paper's three experiments."""

from repro_torch.data.synthetic import logistic_data, robust_data, softmax_data

__all__ = ["logistic_data", "robust_data", "softmax_data"]
