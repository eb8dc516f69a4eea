"""Pressure solvers: geometric multigrid and its backend."""
