"""Pressure solvers: geometric multigrid, conjugate gradient and the
pressure backends."""
