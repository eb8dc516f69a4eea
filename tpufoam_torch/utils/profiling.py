"""Tracing / profiling utilities.

The reference instruments with POSIX clock_gettime + printf around the
embedded-Python call (DLPoissonFoam.C:74-76,106-111) and ad-hoc
time.time() pairs in python_module.py:262-499. Here `StageTimer` wraps
host-visible stages (synchronising the card that holds the stage's
result, so that the numbers mean something), `trace` wraps a region in
a torch.profiler trace written under a directory (open it in Perfetto
or chrome://tracing), `annotate` names a region in that timeline, and
`memory_report` reads the host's and each card's memory.

The program's own spans (`span`, named `tpufoam_torch.<phase>`) mark the
phases of the PISO step where their work happens. They are off unless
`enable_spans(True)`; on, each keeps its count and host time (total and
self) in a table (`span_table`), and inside a torch.profiler session it is
also a `record_function` range, so that every kernel can be put under the
span whose host interval holds its launch. `StageTimer` synchronises the
card and has no place on the step's path. `host_read` is the step's one
way to bring a value to the host, and `host_upload` its one way to copy an
array from the host to the card; both wait for the card's stream, and
`host_read.count` counts them all.
"""

from __future__ import annotations

import contextlib
import os
import threading
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


# ---- the program's spans and host reads ----------------------------------

PREFIX = "tpufoam_torch."
_spans_on = False          # enable_spans; off, span() is one branch
_NULL = contextlib.nullcontext()
_local = threading.local()  # .top: the thread's innermost open span
_lock = threading.Lock()   # the table's updates
_table: dict = {}          # name -> [count, host ns, self ns]


class _Span:
    """One open span: its host interval, the part of it its child spans
    cover, its parent (the thread's stack of open spans, innermost
    first) and the profiler range it opened (if a session was
    running)."""

    __slots__ = ("name", "rf", "t0", "child", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = (annotate(self.name).__enter__()
                   if torch.autograd._profiler_enabled() else None)
        self.child = 0
        self.parent = getattr(_local, "top", None)
        _local.top = self
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        _local.top = self.parent
        if self.parent is not None:
            self.parent.child += dur
        with _lock:
            row = _table.get(self.name)
            if row is None:
                row = _table[self.name] = [0, 0, 0]
            row[0] += 1
            row[1] += dur
            row[2] += dur - self.child
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """The program's span `name` (which starts with `tpufoam_torch.`)
    around a phase: with spans off a shared null context (no clock read,
    no allocation, no profiler range); on, a `_Span`."""
    if not _spans_on:
        return _NULL
    return _Span(name)


def enable_spans(on: bool = True) -> bool:
    """Switch the program's spans on or off; returns the previous
    setting."""
    global _spans_on
    was, _spans_on = _spans_on, bool(on)
    return was


def span_table() -> dict:
    """{name: {"count", "host_s", "self_s"}} of the spans closed since
    the last `reset_spans`: calls, host seconds inside the span, and
    host seconds inside it but outside its child spans."""
    with _lock:
        rows = [(name, *row) for name, row in _table.items()]
    return {name: {"count": n, "host_s": tot / 1e9, "self_s": own / 1e9}
            for name, n, tot, own in rows}


def reset_spans():
    """Clear the span table."""
    with _lock:
        _table.clear()


def _host_value(t: torch.Tensor):
    return t.item() if t.dim() == 0 else t.cpu()


def host_read(t: torch.Tensor):
    """The host's value of `t`: a 0-d tensor's Python number, else its
    copy in host memory (a CPU tensor). On a card it waits for the stream.
    Every call counts in `host_read.count`; with spans on it is the span
    `tpufoam_torch.host_read`, so the host's blocked time is its own."""
    host_read.count += 1
    if not _spans_on:
        return _host_value(t)
    with _Span("tpufoam_torch.host_read"):
        return _host_value(t)


# host reads and host uploads made, counted
host_read.count = 0


def host_upload(a, device) -> torch.Tensor:
    """`torch.as_tensor(a, device=device)` of a host array: from pageable
    memory the copy waits for the card's stream, as a read does, so it
    counts in `host_read.count` and is timed under the span
    `tpufoam_torch.host_read`."""
    host_read.count += 1
    if not _spans_on:
        return torch.as_tensor(a, device=device)
    with _Span("tpufoam_torch.host_read"):
        return torch.as_tensor(a, device=device)


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
