"""Measurement tools for the port; they run on a CUDA card."""
