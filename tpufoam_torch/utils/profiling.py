"""Tracing / profiling utilities.

The reference instruments with POSIX clock_gettime + printf around the
embedded-Python call (DLPoissonFoam.C:74-76,106-111) and ad-hoc
time.time() pairs in python_module.py:262-499. Here `StageTimer` wraps
host-visible stages (synchronising the card that holds the stage's
result, so that the numbers mean something), `trace` wraps a region in
a torch.profiler trace written under a directory (open it in Perfetto
or chrome://tracing), `annotate` names a region in that timeline, and
`memory_report` reads the host's and each card's memory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tensor or a tree of them
    (dicts, lists, tuples, dataclass-like objects with tensor
    attributes)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        parts = tree.values()
    elif isinstance(tree, (list, tuple)):
        parts = tree
    elif hasattr(tree, "__dict__"):
        parts = vars(tree).values()
    else:
        return set()
    return set().union(*(_cuda_devices(p) for p in parts))


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> timer = StageTimer()
    >>> with timer("pressure_solve", block_on=p):
    ...     p = backend(...)            # device work
    >>> print(timer.report())
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and self.sync:
                for d in _cuda_devices(block_on):
                    torch.cuda.synchronize(d)
            dt = time.perf_counter() - t0
            self.totals[stage] += dt
            self.counts[stage] += 1

    def report(self) -> str:
        lines = []
        for stage in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[stage]
            n = self.counts[stage]
            lines.append(f"{stage:<28s} {tot * 1e3:10.2f} ms total"
                         f"  {tot / n * 1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the enclosed region (host ops, and the
    card's kernels where there is a card), written as a Chrome trace
    `trace_<pid>_<ns>.json` under `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return torch.profiler.record_function(name)


def memory_report() -> dict:
    """Host + device memory snapshot (the reference probes /proc/meminfo,
    python_module.py:136-151; we add per-card memory): `device_<i>` for
    each CUDA card, with the bytes PyTorch's allocator holds in tensors
    (`bytes_in_use`), their peak since the last reset
    (`peak_bytes_in_use`) and the card's memory (`bytes_limit`)."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            info = dict(line.split(":")[0:1] + [line.split()[1]]
                        for line in f if ":" in line)
        out["host_total_kb"] = int(info.get("MemTotal", 0))
        out["host_available_kb"] = int(info.get("MemAvailable", 0))
    except OSError:
        pass
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"device_{i}"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.get_device_properties(i)
                .total_memory,
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak",
                                               0),
            }
    return out
