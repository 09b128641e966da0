"""One run of one cell: set-up, the measured window, the check that
decides ``correct``, the metrics, and the result line.

``execute`` is the run without the look for a chip (the tests drive it
on the CPU at tiny sizes); ``run.main`` adds that look and prints.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "orbax", "abstracts_search_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT, parked: bool = False) -> dict:
    """``BENCHMARK.json``; with ``parked``, also the entries of the cells
    kept in ``parked.json`` (harness and tests, no bound), for the tests
    and the knee sweep. A run takes only the benchmark's own cells."""
    spec = load_json(root / "BENCHMARK.json")
    if parked:
        extra = load_json(PKG / "parked.json")
        for key in ("workloads", "end_to_end", "per_layer"):
            spec[key] = spec[key] + extra[key]
    return spec


def cell_files(spec: dict, name: str, root: Path = ROOT):
    """A workload's entry, its configuration (the file's content) and its
    traffic mix (``traffic/<traffic>.json``)."""
    work = {w["name"]: w for w in spec["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[work["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(PKG / "traffic" / f"{work['traffic']}.json")
    return work, config, traffic


def metrics_of(spec: dict, work: dict, trace: bool) -> list:
    """The metric entries a run of ``work`` reports: its end-to-end
    metrics without tracing, its per-layer metrics with it."""
    name = work["name"]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def reader(metric: str):
    """``metrics/<metric>.py``: its ``read(run) -> float | None``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Run:
    """What a window leaves for the metric readers."""

    def __init__(self, config: dict, traffic: dict, trace: bool):
        self.config, self.traffic, self.trace = config, traffic, trace
        self.setup_s = math.nan
        self.window_s = math.nan
        self.attempted = self.failed = 0
        self.latencies_ms: list = []     # every request due in the window; inf if it failed
        self.queries = 0                 # queries completed in the window
        self.jobs: list = []             # (rows, seconds, fill_stats) of whole jobs
        self.op_costs: dict = {}         # op -> {call: (ops, bytes, kind)} in the traced slice
        self.op_device_s: dict = {}      # op -> {call: device seconds} (CUDA events)
        self.counters: dict = {}
        self.profile: dict | None = None  # yardstick.timeline.read_trace of the slice
        self.span_log = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Host-clock span; ``sync`` (a callable) runs before each end
        so the span covers the device work it enqueued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            with self._lock:
                self.span_log.append((name, t0, time.perf_counter(), threading.get_ident()))

    def spans(self, name: str) -> list:
        return [(a, b) for n, a, b, _ in self.span_log if n == name]


class Slice:
    """torch.profiler over a steady slice of the window (traced runs),
    between two marker ranges, reduced by ``read_trace``."""

    def __init__(self, run: Run, start_s: float, length_s: float):
        self.run, self.start_s, self.length_s = run, start_s, length_s
        self.prof = None
        self.done = not run.trace

    def active(self) -> bool:
        """Whether the profiler is on (op calls made now are in the trace)."""
        return self.prof is not None and not self.done

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that its own start-up (the
        CUPTI set-up takes seconds) falls in set-up, not in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            torch.ones(8).sum()
            if torch.cuda.is_available():
                torch.ones(8, device="cuda").sum()
                torch.cuda.synchronize()
        prof.events()

    def poll(self, elapsed: float) -> None:
        """Begin once ``elapsed`` (window seconds) reaches the start; end
        ``length_s`` after the begin marker (the profiler's own start-up
        is not in the slice)."""
        if self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            self.begin()
        elif self.prof is not None and time.perf_counter() - self.began >= self.length_s:
            self.end()

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        with record_function("portbench::slice_begin"):
            pass
        self.began = time.perf_counter()

    def end(self) -> None:
        """Stop the profiler; the trace is read in ``finish``, once the
        window has closed."""
        import torch
        from torch.profiler import record_function

        if self.done or self.prof is None:
            return
        with record_function("portbench::slice_end"):
            pass
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.done = True

    def finish(self) -> None:
        from .yardstick.timeline import read_trace

        self.end()
        if self.prof is None:
            return
        marks = {e.name: e.time_range for e in self.prof.events()
                 if e.name.startswith("portbench::slice_")}
        lo = marks["portbench::slice_begin"].start
        hi = marks["portbench::slice_end"].end
        self.run.profile = read_trace(self.prof, lo, hi)
        self.prof = None


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def execute(work: dict, config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
            device: str, t0: float, metric_entries: list, cell=None) -> dict:
    """One run -> {"correct", "attempted", "failed", "metrics", "device",
    ["breakdown"], "checks"}. ``cell``: a driver's cell built by the
    caller (the fault tests break its timed path first)."""
    import torch

    if cell is None:
        cell = driver(traffic["driver"]).Cell(config, traffic, seed=seed, device=device)
    cell.setup()
    if trace:
        Slice.warm()
    run = Run(config, traffic, trace)
    run.setup_s = time.perf_counter() - t0
    cell.window(seconds, run)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    cell.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = cell.check(run)
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    for m in metric_entries:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(work.get("chips", 1)), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    if run.profile is not None:
        out["_profile"] = run.profile
    return out
