"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer readers and the result line need: the device's busy seconds (the
union of its operations' intervals), the device time of each kernel family
(named by ``kernels/<K>.py``'s patterns), the device operations that took
most time, and the idle gaps grouped by what the host was doing meanwhile
(the innermost host operation open at each gap's middle)."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW_SPAN = "bench.window"
TOP = 10
NAME_CHARS = 120


@dataclass
class Trace:
    busy_s: float
    window_s: float
    device_s_by_name: Dict[str, float]
    idle_s_by_host_op: Dict[str, float]
    kernel_s: Dict[str, float] = field(default_factory=dict)

    def breakdown(self) -> Dict[str, List[List]]:
        top = lambda d: [[k[:NAME_CHARS], v] for k, v in
                         sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]
        return {"device_ops": top(self.device_s_by_name),
                "idle_gaps": top(self.idle_s_by_host_op)}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(prof, kernel_patterns: Dict[str, str]) -> Trace:
    """``kernel_patterns``: kernel family -> a regular expression matched
    against the device operations' names.  Reads the profiler's raw events
    (times in ns), not its event tree, which takes minutes to build for a
    window of some 10**5 operations."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW_SPAN
              and e.device_type() != torch.autograd.DeviceType.CUDA]
    if not window:
        raise RuntimeError(f"the trace holds no '{WINDOW_SPAN}' span")
    w0, w1 = window[0].start_ns(), window[0].start_ns() + window[0].duration_ns()
    dev, host = [], []
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t < w0 or s > w1:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((max(s, w0), min(t, w1), e.name()))
        elif e.name() != WINDOW_SPAN:
            host.append((s, t, e.name(), e.start_thread_id()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) / 1e9
    merged = _merge([(s, t) for s, t, _ in dev])
    busy_ns = sum(t - s for s, t in merged)
    compiled = {k: re.compile(p) for k, p in kernel_patterns.items()}
    kernel_s = {k: sum(v for n, v in by_name.items() if c.search(n)) for k, c in compiled.items()}

    # idle gaps, each given to the innermost host operation open at its middle
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    stacks: Dict[int, list] = defaultdict(list)
    idle: Dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        k = bisect.bisect_right(starts, mid)
        while j < k:
            s, t, name, th = host[j]
            st = stacks[th]
            while st and st[-1][1] < s:
                st.pop()
            st.append((s, t, name))
            j += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < mid:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        idle[best[2] if best else "(host Python between operations)"] += (g1 - g0) / 1e9
    return Trace(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9, device_s_by_name=dict(by_name),
                 idle_s_by_host_op=dict(idle), kernel_s=kernel_s)
