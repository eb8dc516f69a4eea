"""Device kernels the profiler saw per traced step (memory copies and
sets left out)."""


def read(d):
    t = d["trace"]
    if not t or not t["launches"]:
        return None
    return t["launches"] / d["steps"]
