"""One traced segment of a run: `torch.profiler` over CPU and CUDA around
a call, reduced to what the per-layer readers and the result's
`breakdown` take.  Frozen from the port's chip check (its `traced` and
`profile_window`), extended by the timeline: the device's busy seconds as
the union of its kernels' intervals, and each idle gap named by the
host's innermost op on the calling thread while the device waited."""
from __future__ import annotations

import collections
import dataclasses
import time

import torch

SPAN = "bench.traced"


@dataclasses.dataclass
class Trace:
    window_s: float                 # wall seconds of the traced call
    busy_s: float                   # union of device-op intervals
    ops: dict                       # device op name -> [seconds, launches]
    gaps: dict                      # host op name -> idle seconds

    def mean_launch_s(self, *fragments: str) -> float | None:
        """Device seconds per launch of each matching op, summed over the
        matching names (one call may launch several); None if none ran."""
        means = [s / c for name, (s, c) in self.ops.items()
                 if c and any(f in name for f in fragments)]
        return sum(means) if means else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _is_device(evt) -> bool:
    return str(evt.device_type).endswith("CUDA")


def traced(fn, device: torch.device) -> Trace:
    """Run `fn()` once under the profiler and reduce its timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN):
            fn()
        sync()
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    """The device ops, busy seconds and named idle gaps of a profiler's
    events (`prof.events()`)."""
    device, host = [], []
    span = None
    for evt in events:
        if _is_device(evt):
            # a user annotation (the span itself, on the device's timeline)
            # is no device op
            if not (getattr(evt, "is_user_annotation", False)
                    or evt.name == SPAN):
                device.append(evt)
        else:
            host.append(evt)
            if evt.name == SPAN:
                span = evt
    ops = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in device:
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        ops[evt.name][0] += (end - start) * 1e-6
        ops[evt.name][1] += 1
        intervals.append((start, end))
    intervals.sort()
    merged = []
    for start, end in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = _named_gaps(merged, host, span)
    return Trace(window_s=window_s, busy_s=busy_s, ops=dict(ops), gaps=gaps)


def _named_gaps(merged: list, host: list, span) -> dict:
    """Seconds the device sat idle between its ops inside the traced span,
    by the innermost host op of the calling thread at each gap's middle."""
    if span is None or not merged:
        return {}
    thread = span.thread
    mine = sorted((e for e in host if e.thread == thread),
                  key=lambda e: (e.time_range.start, -e.time_range.end))
    lo, hi = span.time_range.start, span.time_range.end
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    out = collections.defaultdict(float)
    stack, j = [], 0
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        gap_start, gap_end = max(gap_start, lo), min(gap_end, hi)
        if gap_end <= gap_start:
            continue
        mid = 0.5 * (gap_start + gap_end)
        # a sweep over the thread's ops by start: the ops of one thread
        # nest, so the top of the stack of those still running at `mid`
        # is the innermost
        while j < len(mine) and mine[j].time_range.start <= mid:
            evt = mine[j]
            while stack and stack[-1].time_range.end < evt.time_range.start:
                stack.pop()
            stack.append(evt)
            j += 1
        while stack and stack[-1].time_range.end < mid:
            stack.pop()
        out[stack[-1].name if stack else SPAN] += (gap_end - gap_start) * 1e-6
    return dict(out)
