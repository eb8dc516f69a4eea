"""Grids, geometry, the wall-distance feature and mesh <-> grid
resampling."""
