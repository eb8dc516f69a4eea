"""Share of a step in which no kernel ran on the device: one minus the
device's busy time a traced step (the union of the kernels' intervals
over the traced steps, divided by their count) over the time an untraced
step of the same run takes (the probe steps just before the traced
ones, timed by CUDA events as the window times its steps). The
profiler's host-side tracing slows the dispatch of a traced step and
not the device's work, so the traced steps' own length would read the
idle share too high."""


def read(d):
    t = d["trace"]
    if not t or t["busy_s"] <= 0 or not d.get("probe_step_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / d["steps"] / d["probe_step_s"])
