"""Finite-volume case, operators, pressure and momentum assembly."""
