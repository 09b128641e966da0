"""Stage timers and torch.profiler hooks."""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from pathlib import Path

logger = logging.getLogger(__name__)

PROFILE_ENV = "ASTPU_PROFILE"


class StageTimer:
    """Collects named stage durations; writeable as a JSON report."""

    def __init__(self):
        self.stages: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        err = None
        try:
            yield
        except BaseException as e:
            err = repr(e)
            raise
        finally:
            dt = time.perf_counter() - t0
            rec = {"stage": name, "seconds": round(dt, 4), **meta}
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
    trace opens in Perfetto or chrome://tracing."""
    out = os.environ.get(PROFILE_ENV)
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(out) / name
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    trace = path / "trace.json"
    prof.export_chrome_trace(str(trace))
    logger.info("profile for %s written to %s", name, trace)


def timed(fn):
    """Decorator: log wall-clock of a function call at INFO."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            logger.info("%s: %.3fs", fn.__qualname__, time.perf_counter() - t0)

    return wrapper
