"""Device time of the residual safeguard per step: the kernels launched
inside the program's span `piso.safeguard` (its residual checks and
rescue solves; spans.reduce) over the traced steps; 0 where the step
launched kernels and no safeguard ran. Silent where the step itself
launched no kernel (no device, or spans off)."""


def read(d):
    sp = d["spans"]
    if not sp.get("tpufoam_torch.piso.step", {}).get("device_s"):
        return None
    s = sp.get("tpufoam_torch.piso.safeguard", {}).get("device_s", 0.0)
    return s * 1e3 / d["steps"]
