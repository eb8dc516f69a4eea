"""Validation against published benchmarks (Schaefer & Turek 1996), and
the offline evaluation of surrogate bundles."""

from .evaluation import evaluate_bundle, EvalReport

__all__ = ["EvalReport", "evaluate_bundle"]
