"""Grids, geometry and the wall-distance feature."""
