"""Regularizers (the Gaussian-quant eval branch)."""
