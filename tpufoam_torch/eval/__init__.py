"""Validation against published benchmarks (Schaefer & Turek 1996)."""
