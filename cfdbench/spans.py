"""The program's own spans in a torch.profiler trace: the device time of
the kernels launched inside each `tpufoam_torch.*` span, and the idle
gaps named by the span that was open.

The program opens its spans (tpufoam_torch.utils.profiling.span) only
when they are switched on; inside a profiler session each is a
`record_function` range on the launching thread, and on the CUDA side a
user annotation, which is no kernel. A kernel belongs to a span when the
runtime call that launched it (the same correlation id; else the start
of the host operation it is linked to) lies inside the span's host
interval, the rule `trace.read` applies to the benchmark's own ranges.
Spans nest on one thread, so the spans holding a launch form a chain:
the kernel's device time counts in full for each span of the chain
(inclusive) and for the innermost alone (self).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

PROGRAM = "tpufoam_torch."
OUR = "cfdbench."


def events(prof) -> tuple[list, list]:
    """(host events, kernels) of a finished torch.profiler.profile: host
    events as (start ns, end ns, name, thread, correlation id, linked
    id); kernels as (start ns, end ns, name, correlation id, linked id),
    memory copies and sets and the ranges' user annotations left out."""
    cpu, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append((e.start_ns(), e.end_ns(), e.name(),
                        e.start_thread_id(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name()
            if name.startswith(("Memcpy", "Memset", PROGRAM, OUR)):
                continue
            kernels.append((e.start_ns(), e.end_ns(), name,
                            e.correlation_id(), e.linked_correlation_id()))
    return cpu, kernels


def launch_times(cpu: list) -> tuple[dict, dict]:
    """({correlation id: start of the runtime call}, {correlation id:
    start of a host operation that other events link to}) in ns."""
    launch, op_start = {}, {}
    for s, _, name, _, corr, linked in cpu:
        if name.startswith("cuda"):
            launch[corr] = s
        elif linked == 0:
            op_start[corr] = s
    return launch, op_start


def _chains(spans: list, times: list) -> list:
    """For each time in `times` (sorted), the names of the spans open at
    it, outermost first. `spans` (start, end, name) nest."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append([x[2] for x in stack])
    return out


def reduce(cpu: list, kernels: list) -> dict:
    """`spans` {name: {"launches", "device_s", "self_s"}} (kernels
    launched inside the span; their device seconds; those of the kernels
    whose innermost span it is), `outside` {"launches", "device_s"} of
    the kernels launched in no program span, and `idle_gaps_by_span`
    [[innermost span at the gap's middle, or "none", seconds]] over the
    gaps between the merged kernel intervals."""
    thread = next((c[3] for c in cpu if c[2].startswith(PROGRAM)), None)
    spans = [(s, e, name) for s, e, name, tid, _, _ in cpu
             if name.startswith(PROGRAM) and tid == thread]
    launch, op_start = launch_times(cpu)
    timed = []
    for ks, ke, _, cid, lid in kernels:
        t = launch.get(cid, op_start.get(lid))
        if t is not None:
            timed.append((t, ke - ks))
    timed.sort()
    table = defaultdict(lambda: [0, 0, 0])
    outside = [0, 0]
    for (t, dur), chain in zip(timed, _chains(spans, [t for t, _ in timed])):
        if not chain:
            outside[0] += 1
            outside[1] += dur
            continue
        for name in set(chain):
            table[name][0] += 1
            table[name][1] += dur
        table[chain[-1]][2] += dur

    merged = []
    for s, e in sorted((k[0], k[1]) for k in kernels):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((e0 + s1) // 2, s1 - e0)
                  for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]))
    idle = defaultdict(int)
    for (_, length), chain in zip(gaps, _chains(spans,
                                                [m for m, _ in gaps])):
        idle[chain[-1] if chain else "none"] += length
    return {
        "spans": {n: {"launches": v[0], "device_s": v[1] / 1e9,
                      "self_s": v[2] / 1e9} for n, v in table.items()},
        "outside": {"launches": outside[0], "device_s": outside[1] / 1e9},
        "idle_gaps_by_span": [[n, v / 1e9] for n, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])],
    }


def launched_in(cpu: list, kernels: list, name: str) -> tuple[int, int]:
    """(kernels launched inside the host events called `name`, kernels in
    all): the share of a region's launches that a span covers is read
    against it."""
    ranges = sorted((s, e) for s, e, n, _, _, _ in cpu if n == name)
    starts = [s for s, _ in ranges]
    launch, op_start = launch_times(cpu)
    inside = 0
    for _, _, _, cid, lid in kernels:
        t = launch.get(cid, op_start.get(lid))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            inside += 1
    return inside, len(kernels)
