"""Validation against published benchmarks (Schaefer & Turek 1996), and
the offline evaluation of surrogate bundles."""

from .evaluation import UnstructuredCase, evaluate_bundle, EvalReport

__all__ = ["EvalReport", "UnstructuredCase", "evaluate_bundle"]
