"""Spans and the profiler's trace, reduced to the readings the metric
readers take.

Spans are (thread, start, end, name) on one clock.  A layer's time is
the union, over threads, of its own spans, less the part of that union
that spans of the layers nested inside it cover (self time, in the
choosing-metrics guide's sense).

The profiled slice (`profiled`) runs a few whole checks under
`torch.profiler` with the card's activity alone (recording the host's
operators as well slows the host's dispatch about three times, and
that dispatch is what keeps the card idle here).  A marker kernel,
launched alone at a host instant the harness notes, ties the card's
clock to the host's, so each idle gap of the card can be named by the
span open on the host then.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional


def union(intervals: Iterable[tuple]) -> list:
    """Sorted disjoint (start, end) intervals covering `intervals`."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals: list) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a: list, b: list) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def layer_time(spans: list, names: set, nested: set = frozenset()) -> float:
    """Seconds of `spans` (microsecond clock) under spans named in
    `names`, less what spans named in `nested` cover inside them."""
    own = union((s, e) for _, s, e, n in spans if n in names)
    if nested:
        inner = union((s, e) for _, s, e, n in spans if n in nested)
        return (length(own) - length(intersect(own, inner))) / 1e6
    return length(own) / 1e6


def innermost(spans: list) -> list:
    """(start, end, name) pieces of the span timeline, each named by the
    innermost span open then on any thread (the one that started
    last)."""
    edges = sorted({t for _, s, e, _ in spans for t in (s, e)})
    if not edges:
        return []
    by_start = sorted(spans, key=lambda x: x[1])
    out, k, live = [], 0, []
    for a, b in zip(edges, edges[1:]):
        while k < len(by_start) and by_start[k][1] <= a:
            live.append(by_start[k])
            k += 1
        live = [x for x in live if x[2] > a]
        if live:
            out.append((a, b, max(live, key=lambda x: x[1])[3]))
    return out


def name_gaps(gaps: list, spans: list, outside: str) -> dict:
    """{name: seconds} of the card's idle `gaps` (host microseconds),
    each piece named by the innermost host span then, or `outside`."""
    pieces = innermost(spans)
    out: dict = {}
    for gs, ge in gaps:
        covered = 0.0
        for s, e, name in pieces:
            lo, hi = max(gs, s), min(ge, e)
            if lo < hi:
                out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
                covered += hi - lo
        if ge - gs > covered:
            out[outside] = out.get(outside, 0.0) + (ge - gs - covered) / 1e6
    return out


def _device_events(prof) -> list:
    """(name, start_us, end_us) of every operation the profiler saw on
    the card (kernels, copies, sets)."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def profiled(run: Callable[[], None], take_spans: Callable[[], tuple],
             span: Callable[[str], object]) -> Optional[dict]:
    """Runs `run` (whole checks, ending in a synchronize) under the
    profiler -> {"busy_s", "window_s", "kernel_s": {name: seconds},
    "gaps_s": {host span: seconds}, "spans_dropped"}, or None when the
    profiler saw no device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    take_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span("perfbench.mark"):
            t_mark = time.perf_counter_ns()
        mark.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    spans, dropped = take_spans()
    events = sorted(_device_events(prof), key=lambda x: x[1])
    if len(events) < 2:
        return None
    marks = [s for _, s, _, n in spans if n == "perfbench.mark"]
    # Host microseconds on the spans' clock of the card's instant d:
    # the marker is the first operation, launched at t_mark.
    t_mark_us = marks[0] if marks else 0.0
    shift = t_mark_us - events[0][1]
    lo = events[0][1] + (t0 - t_mark) / 1e3
    hi = lo + (t1 - t0) / 1e3
    work = [(n, max(s, lo), min(e, hi)) for n, s, e in events[1:]]
    work = [(n, s, e) for n, s, e in work if s < e]
    busy = union((s, e) for _, s, e in work)
    kernel_s: dict = {}
    for n, s, e in work:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e6
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at + shift, s + shift))
        at = max(at, e)
    if hi > at:
        gaps.append((at + shift, hi + shift))
    return {
        "busy_s": length(busy) / 1e6,
        "window_s": (t1 - t0) / 1e9,
        "kernel_s": kernel_s,
        "gaps_s": name_gaps(gaps, [x for x in spans
                                   if x[3] != "perfbench.mark"],
                            "perfbench.check"),
        "spans_dropped": dropped,
    }
