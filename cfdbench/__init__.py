"""The benchmark of tpufoam_torch on one H100 (see run.py)."""
