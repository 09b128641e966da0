"""The port's tracer: spans at its layer boundaries, the stage timer of
the build report, and the ``ASTPU_PROFILE`` profiler scope.

``span(name, *, device=None, **counts)`` is a context manager around one
layer's work. The tracer is on between ``start()`` and ``stop()``, and
while a ``torch.profiler`` session runs, so every profiler trace carries
the port's spans.

- Off (the default), ``span`` returns one shared object that does
  nothing: no clock read, no CUDA call, no profiler range.
- On, a span records its name, its host start and end
  (``time.perf_counter_ns``), its thread, its id and the id of the span
  that caused it (the innermost span open on that thread), and
  ``counts``: the integers the layer knows as it enters that boundary
  (queries, slots, rows, bytes). It also opens a profiler range,
  ``astpu::<name>``, with the counts as its arguments, so a running
  profiler holds it as a host range on the profiler's own clock, beside
  the device's events: idle gaps of the device are named by the spans
  open over them, and a profiler that records shapes (``profile_scope``)
  writes the counts into the range's ``args``.
- With ``device`` a CUDA device, a span also records a pair of CUDA
  events (from a reusable pool) on that device's current stream at entry
  and exit. Nothing waits for them: ``collect()`` resolves every pending
  device time after one synchronise.

``measure(name, ...)`` is a span that reads the host clock (and, on the
card, records its events) whether or not the tracer is on, for stage
seconds the program keeps: ``StageTimer``'s report and
``IVFPQIndex.fill_stats``. While the tracer is on it is also one of its
spans.

While the tracer is on, each pause of Python's garbage collector is a
profiler range too, ``astpu::gc`` (its generation as an argument), so
the idle time a collection causes is named in a trace. It is no span: a
collection is no layer's work, and the span it falls in keeps it in its
self time. The ``gc`` callback that opens it is registered by the first
span that records and taken away by ``stop`` or ``collect`` once the
tracer is off, so an untraced process pays nothing per collection.

The tracer is shared by the threads of a process (the delta fan-out
pool, the HTTP server's threads): each thread has its own stack of open
spans, and the record list and the event pool take a lock.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import logging
import os
import threading
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

PROFILE_ENV = "ASTPU_PROFILE"
PREFIX = "astpu::"

# a profiler range: torch's C++ one (about a microsecond with counts;
# ``record_function`` dispatches an op on entry and exit). Its
# ``keyword_values`` must be a dict (anything else aborts the process)
# of ints (any other number warns on every entry).
_Range = torch._C._profiler._RecordFunctionFast

_on = False                      # between start() and stop()
_lock = threading.Lock()
_records: list = []              # closed spans since start() or the last collect()
_pool: list = []                 # CUDA event pairs free for reuse
_ids = itertools.count(1)
_local = threading.local()       # .stack: this thread's open spans
_gc_open = None                  # the profiler range of a collection under way
_gc_watched = False              # _gc_range is in gc.callbacks


class _Off:
    """The span of a tracer that is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


OFF = _Off()


class Span:
    """One span; ``host_s`` once it has closed. Made by ``span`` or
    ``measure``."""

    __slots__ = ("name", "counts", "device", "traced", "id", "parent", "thread",
                 "start_ns", "end_ns", "events", "stream", "pooled", "range")

    def __init__(self, name: str, device, counts: dict, traced: bool):
        self.name, self.traced = name, traced
        self.counts = {k: int(v) for k, v in counts.items()} if traced else counts
        self.device = None if device is None else torch.device(device)
        self.id = self.parent = self.thread = self.events = self.stream = self.range = None
        self.pooled = False

    def __enter__(self):
        if self.traced:
            if not _gc_watched:
                _watch_gc(True)
            stack = _stack()
            self.id = next(_ids)
            self.parent = stack[-1].id if stack else None
            self.thread = threading.get_ident()
            stack.append(self)
            self.range = _Range(PREFIX + self.name, keyword_values=self.counts)
            self.range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.pooled = self.traced
            self.events = _take_events() if self.pooled else _new_events()
            # the stream is looked up once: each lookup costs microseconds
            self.stream = torch.cuda.current_stream(self.device)
            self.events[0].record(self.stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
            self.stream = None
        if self.traced:
            self.range.__exit__(None, None, None)
            self.range = None
            _stack().remove(self)
            with _lock:
                _records.append(self)
        return None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def device_seconds(self) -> float:
        """The device's time between the span's events, once they have
        completed (the caller has synchronised); off the card, where the
        work is done when the host returns, its host seconds."""
        if self.events is None:
            return self.host_s
        return self.events[0].elapsed_time(self.events[1]) / 1e3


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _new_events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _take_events():
    with _lock:
        if _pool:
            return _pool.pop()
    return _new_events()


def enabled() -> bool:
    """Whether spans record now: after ``start()``, or under a profiler."""
    return _on or _autograd_profiler._is_profiler_enabled


def span(name: str, *, device=None, **counts):
    """A span around one layer's work (module docstring); ``device``:
    the torch device the work runs on, for its device time."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return OFF
    return Span(name, device, counts, True)


def measure(name: str, *, device=None, **counts) -> Span:
    """A span that times itself whether or not the tracer is on."""
    return Span(name, device, counts, _on or _autograd_profiler._is_profiler_enabled)


def _gc_range(phase: str, info: dict) -> None:
    """``gc.callbacks``: an ``astpu::gc`` range around each collection
    while the tracer is on (module docstring)."""
    global _gc_open
    if phase == "start":
        if _on or _autograd_profiler._is_profiler_enabled:
            _gc_open = _Range(PREFIX + "gc", keyword_values={"generation": info["generation"]})
            _gc_open.__enter__()
    elif _gc_open is not None:
        _gc_open.__exit__(None, None, None)
        _gc_open = None


def _watch_gc(on: bool) -> None:
    global _gc_watched
    with _lock:
        if on and not _gc_watched:
            gc.callbacks.append(_gc_range)
        elif not on and _gc_watched:
            gc.callbacks.remove(_gc_range)
        _gc_watched = on


def start() -> None:
    """Turn the tracer on, dropping spans not yet collected."""
    global _on
    with _lock:
        _records.clear()
    _on = True


def stop() -> None:
    """Turn the tracer off (a running profiler still turns it on); the
    spans recorded stay for ``collect``."""
    global _on
    _on = False
    if not enabled():
        _watch_gc(False)


def collect() -> list[dict]:
    """The spans closed since ``start()`` or the last ``collect()``, in
    the order they closed, each a dict: ``name``, ``id``, ``parent`` (the
    causing span's id, or None), ``thread``, ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``), ``host_s``, ``self_s`` (host seconds less
    the part its children among these spans cover), ``device_s`` (for a
    span with a device: by its CUDA events on the card, its host seconds
    off the card; else None) and ``counts``. One synchronise of each card
    that has events pending, then the events go back to the pool."""
    with _lock:
        spans = list(_records)
        _records.clear()
    for dev in {s.device for s in spans if s.events is not None}:
        torch.cuda.synchronize(dev)
    child_s: dict = {}
    for s in spans:
        if s.parent is not None:
            child_s[s.parent] = child_s.get(s.parent, 0.0) + s.host_s
    out = []
    for s in spans:
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "thread": s.thread,
                    "start_ns": s.start_ns, "end_ns": s.end_ns, "host_s": s.host_s,
                    "self_s": s.host_s - child_s.get(s.id, 0.0),
                    "device_s": None if s.device is None else s.device_seconds(),
                    "counts": dict(s.counts)})
        if s.pooled:
            with _lock:
                _pool.append(s.events)
            s.events, s.pooled = None, False
    if not enabled():
        _watch_gc(False)
    return out


class StageTimer:
    """Collects named stage durations; writeable as a JSON report. Each
    stage is a ``stage.<name>`` span of the tracer (``measure``).

    With ``counters`` (a callable -> {name: count}, e.g.
    ``ops.launch_counts``) each stage also records the counts it moved
    under ``launches``. ``stage`` yields a dict whose entries the caller
    may fill in; they join the stage's record."""

    def __init__(self, counters=None):
        self.stages: list[dict] = []
        self.counters = counters

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        c0 = self.counters() if self.counters else None
        extra: dict = {}
        err = None
        sp = measure("stage." + name)
        try:
            with sp:
                yield extra
        except BaseException as e:
            err = repr(e)
            raise
        finally:
            dt = sp.host_s
            rec = {"stage": name, "seconds": round(dt, 4), **meta, **extra}
            if c0 is not None:
                rec["launches"] = {k: v - c0.get(k, 0) for k, v in self.counters().items()
                                   if v != c0.get(k, 0)}
            if err:
                rec["error"] = err
            self.stages.append(rec)
            logger.info("stage %s: %.3fs%s", name, dt, f" ({err})" if err else "")

    def report(self) -> dict:
        return {"stages": self.stages, "total_seconds": round(
            sum(s["seconds"] for s in self.stages), 4)}

    def write(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.report(), indent=2))


@contextlib.contextmanager
def profile_scope(name: str):
    """Record this scope with torch.profiler (host and CUDA activity)
    when ASTPU_PROFILE is set, and write it as a Chrome trace under
    ``$ASTPU_PROFILE/<name>/``; without the variable, do nothing. The
    running profiler turns the tracer on, so the trace holds the port's
    ``astpu::`` spans, their counts in each range's ``args`` (the
    profiler records shapes for that). It opens in Perfetto or
    chrome://tracing. The scope's spans are not kept for ``collect``
    unless the tracer was started."""
    out = os.environ.get(PROFILE_ENV)
    if not out:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(out) / name
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    if not _on:
        collect()
    trace = path / "trace.json"
    prof.export_chrome_trace(str(trace))
    logger.info("profile for %s written to %s", name, trace)
