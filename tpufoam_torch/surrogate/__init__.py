"""Surrogate serving: features, PCA, blocks, stitching, predictor."""
