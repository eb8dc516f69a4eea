"""The PISO timestep engine."""
