"""Bayesian GLMs for the paper's experiments."""
