"""Device time of the kernels launched inside the benchmark's range
around the bound predictor it hands the step, per step."""


def read(d):
    t = d["trace"]
    s = t["range_s"].get("surrogate") if t else None
    return s * 1e3 / d["steps"] if s else None
