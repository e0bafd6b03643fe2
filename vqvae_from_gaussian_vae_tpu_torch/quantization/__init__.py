"""Regularizers: GQ (the paper's), GQ2, VQ, FSQ, LFQ, BSQ, Gaussian, Identity."""
