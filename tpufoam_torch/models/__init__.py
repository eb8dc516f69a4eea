"""Networks on PCA coefficients."""
