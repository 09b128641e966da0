"""Reductions of timings: percentiles, spreads and the device trace.

The busy time of a device is the union of its kernel and copy
intervals (a frozen copy of the port's smoke ``profile_batches``)."""

from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """Nearest-rank percentile of every value (``inf`` counts as a miss)."""
    v = sorted(values)
    if not v:
        return math.nan
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def spread(values) -> float:
    """Interquartile range over the median (``statistics.quantiles``)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle [start, end) intervals of [lo, hi) outside ``intervals``."""
    out, at = [], lo
    for a, b in union(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


RANGE = "portbench::"


def op_label(name: str) -> str:
    """An event's name, with the call number of an op range dropped."""
    return name.split("#")[0] if name.startswith(RANGE) else name


def read_trace(prof, lo_us: float, hi_us: float) -> dict:
    """A torch.profiler run -> the device's busy seconds in [lo, hi) (its
    timestamps, microseconds), the device seconds by kernel name, and the
    idle seconds by what the host was doing (the innermost host op over
    each gap's middle; "no host op" where none ran)."""
    import torch

    dev, host = [], []
    events = prof.events()
    seen = {"cpu": [math.inf, -math.inf, 0], "device": [math.inf, -math.inf, 0]}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        s = seen["device" if e.device_type == torch.autograd.DeviceType.CUDA else "cpu"]
        s[0], s[1], s[2] = min(s[0], a), max(s[1], b), s[2] + 1
        if b <= lo_us or a >= hi_us:
            continue
        a, b = max(a, lo_us), min(b, hi_us)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(RANGE):  # a range's device-side mirror
                dev.append((a, b, e.name))
        else:
            host.append((a, b, op_label(e.name)))
    by_name: dict = {}
    for a, b, name in dev:
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + (b - a) / 1e6
    host.sort()
    idle: dict = {}
    active, at = [], 0
    # a sweep over the gaps' middles in order: the host ops open there
    for a, b in gaps([(x, y) for x, y, _ in dev], lo_us, hi_us):
        mid = (a + b) / 2
        while at < len(host) and host[at][0] <= mid:
            active.append(host[at])
            at += 1
        active = [h for h in active if h[1] >= mid]
        label = (min(active, key=lambda h: h[1] - h[0])[2][:96] if active else "no host op")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy([(a, b) for a, b, _ in dev]) / 1e6,
            "window_s": (hi_us - lo_us) / 1e6, "device_events": len(dev),
            "events_seen": {k: [v[0], v[1], v[2]] for k, v in seen.items()}, "slice_us": [lo_us, hi_us],
            "device_ops": top(by_name), "idle_gaps": top(idle)}
