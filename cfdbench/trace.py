"""What the traced run reads from torch.profiler: the device's busy time
as the union of its kernels' intervals, the device time of the kernels
launched inside each of the benchmark's named ranges, the launches, the
top device operations and the longest idle gaps by what the host was
doing; and, through `spans`, the same of the program's own spans.

Ranges are opened by the benchmark around the calls it makes into the
program (the bound predictor, the pressure backend) and around the
module attributes the program's callers look up (`Ranged`). A kernel
belongs to a range when the runtime call that launched it (the same
correlation id) was made inside the range. The program's spans
(`tpufoam_torch.*`, when they are on) are neither kernels nor host
operations here: `launches`, `busy_s` and `idle_gaps` read the same with
spans on as off.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from . import spans

PREFIX = spans.OUR


class Ranged:
    """A stand-in for a program function that opens the range
    `cfdbench.<name>` around each call and records each call's
    arguments through `on_call`. Attributes read or set on it (the
    function's counters) go to the function itself."""

    def __init__(self, fn, name: str, on_call=None):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_name", PREFIX + name)
        object.__setattr__(self, "_on_call", on_call)

    def __call__(self, *args, **kwargs):
        if self._on_call is not None:
            self._on_call(args, kwargs)
        with torch.profiler.record_function(self._name):
            return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def _union(intervals: list) -> tuple[float, list]:
    """(total length of the union, the merged intervals), ns."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read(prof) -> dict:
    """Reduce a finished torch.profiler.profile to plain numbers
    (`reduce` of its `spans.events`)."""
    return reduce(*spans.events(prof))


def reduce(cpu: list, kernels: list) -> dict:
    """`launches` (device operations; memory copies and sets and the
    ranges' user annotations are not among `kernels`), `busy_s`,
    `range_s` {range name: device seconds of its kernels}, `device_ops`
    [[name, seconds]] (top 10), `idle_gaps` [[host operation, seconds]]
    (top 10), and the program's spans as `spans.reduce` gives them:
    `spans`, `outside` and `idle_gaps_by_span`."""
    # the launching thread: the one that opened the benchmark's ranges
    thread = next((c[3] for c in cpu if c[2].startswith(PREFIX)), None)
    # a kernel's launch time: its runtime call's (the same correlation
    # id), else the start of the host operation it is linked to
    launch, op_start = spans.launch_times(cpu)
    host = []
    ranges = defaultdict(list)
    for s, e, name, tid, _, _ in cpu:
        if name.startswith(PREFIX):
            ranges[name[len(PREFIX):]].append((s, e))
        elif tid == thread and e > s and not name.startswith(
                spans.PROGRAM):
            host.append((s, e, name))
    busy_ns, merged = _union([(k[0], k[1]) for k in kernels])

    # the kernels' device time in each range, by their launching op
    range_ns = {}
    for name, ivals in ranges.items():
        ivals.sort()
        starts = [s for s, _ in ivals]
        tot = 0
        for ks, ke, _, cid, lid in kernels:
            t = launch.get(cid, op_start.get(lid))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivals[i][1]:
                tot += ke - ks
        range_ns[name] = tot

    by_name = defaultdict(int)
    for ks, ke, name, _, _ in kernels:
        by_name[name] += ke - ks
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps between the merged kernel intervals, each named by the
    # innermost host operation running at its middle: one sweep over the
    # host operations (nested on the launching thread) in start order
    mids = sorted(((e0 + s1) // 2, s1 - e0)
                  for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]))
    host.sort(key=lambda h: (h[0], -h[1]))
    gaps = defaultdict(int)
    stack, k = [], 0
    for mid, length in mids:
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "none"] += length
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    return {
        "launches": len(kernels),
        "busy_s": busy_ns / 1e9,
        "range_s": {k: v / 1e9 for k, v in range_ns.items()},
        "device_ops": [[n, v / 1e9] for n, v in top],
        "idle_gaps": [[n, v / 1e9] for n, v in idle],
        **spans.reduce(cpu, kernels),
    }
