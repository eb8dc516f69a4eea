"""Device time of the FV assembly per step: the kernels launched inside
the program's spans `piso.dt`, `fv.momentum_assembly`,
`fv.pressure_assembly` and `fv.correct` (each inclusive of the spans
inside it; spans.reduce) over the traced steps. Silent where the step
itself launched no kernel (no device, or spans off)."""

SPANS = ("piso.dt", "fv.momentum_assembly", "fv.pressure_assembly",
         "fv.correct")


def read(d):
    sp = d["spans"]
    if not sp.get("tpufoam_torch.piso.step", {}).get("device_s"):
        return None
    return sum(sp.get(f"tpufoam_torch.{k}", {}).get("device_s", 0.0)
               for k in SPANS) * 1e3 / d["steps"]
