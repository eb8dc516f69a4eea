"""The pressure matvec's share of its roofline: the least time of its
calls' work (work.kernel_work from each call's shape and dtype) over the
device time of the kernels launched inside the range around
tpufoam_torch.ops.stencil.stencil_matvec."""

from cfdbench import work


def read(d):
    t = d["trace"]
    s = t["range_s"].get("stencil_matvec") if t else None
    calls = d["calls"]["stencil_matvec"]
    if not s or not calls:
        return None
    least = sum(work.least_seconds(*work.kernel_work(
        "stencil_matvec", cells, dtype, sweeps))
        for cells, dtype, sweeps in calls)
    return 100.0 * least / s
