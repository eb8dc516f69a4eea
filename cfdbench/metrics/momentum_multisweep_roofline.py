"""The momentum multisweep's share of its roofline: the least time of its
calls' work (work.kernel_work from each call's shape and sweeps) over the
device time of the kernels launched inside the range around
tpufoam_torch.fv.momentum.momentum_multisweep."""

from cfdbench import work


def read(d):
    t = d["trace"]
    s = t["range_s"].get("momentum_multisweep") if t else None
    calls = d["calls"]["momentum_multisweep"]
    if not s or not calls:
        return None
    least = sum(work.least_seconds(*work.kernel_work(
        "momentum_multisweep", cells, dtype, sweeps))
        for cells, dtype, sweeps in calls)
    return 100.0 * least / s
