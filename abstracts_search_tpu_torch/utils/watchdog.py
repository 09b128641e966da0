"""Deadline watchdog for unattended runs on the card.

The port's copy of the JAX package's ``utils/watchdog.py``. A run that
nobody watches (a cron'd sync, a benchmark) must print an honest failure
record and exit instead of hanging its caller when a device op never
returns.

Usage (before the first device op)::

    from abstracts_search_tpu_torch.utils.watchdog import Watchdog

    with Watchdog(1200, report={"bench": "prod207m"}) as wd:
        ... work on the card ...
        wd.alive()          # optional: re-arm between long stages

If the deadline passes without ``alive()`` or exit, one JSON line
``{"error": "device unreachable ...", **report}`` is printed to stdout
and the process hard-exits (``os._exit``): a hung device op blocks
Python-level cleanup, so graceful shutdown is not an option.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading


class Watchdog:
    """Deadline watchdog; re-armable between stages."""

    def __init__(self, timeout_s: float = 1200.0, *,
                 report: dict | None = None, exit_code: int = 3):
        self.timeout_s = float(timeout_s)
        self.report = dict(report or {})
        self.exit_code = exit_code
        self._beat = threading.Event()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        while True:
            fired = self._beat.wait(self.timeout_s)
            if self._done.is_set():
                return
            if fired:
                self._beat.clear()      # re-armed via alive()
                continue
            line = {"error": f"device unreachable within {self.timeout_s:.0f}s "
                             "(no progress)", **self.report}
            print(json.dumps(line), flush=True)
            sys.stderr.flush()
            os._exit(self.exit_code)

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def alive(self) -> None:
        """Re-arm: the run made progress; grant another full timeout."""
        self._beat.set()

    def stop(self) -> None:
        self._done.set()
        self._beat.set()
        self._detach_logging()

    def attach_to_logging(self) -> "Watchdog":
        """Re-arm on every log record: all long pipeline stages log
        progress (kmeans iterations, fill chunks, stage timers), so a
        live run beats continuously while a hung device op goes silent.
        The deadline then bounds the longest legitimately-silent gap.

        Records are filtered at the LOGGER before any handler runs, so a
        process that never configured logging (root stays at WARNING)
        would deliver zero INFO beats and the deadline would become
        absolute-from-start — hard-killing a healthy >timeout run with a
        false "device unreachable" record. INFO must therefore flow to
        handlers, but without changing what the process PRINTS:
        pre-existing root handlers that relied on the old logger level
        for their threshold get that threshold set explicitly before
        the logger level drops. ``stop()``/``__exit__`` restores
        both."""
        root = logging.getLogger()
        self._prev_root_level: int | None = None
        self._handler_bumps: list[tuple[logging.Handler, int]] = []
        eff = root.getEffectiveLevel()
        if eff > logging.INFO:
            self._prev_root_level = root.level
            for h in root.handlers:
                if h.level < eff:
                    self._handler_bumps.append((h, h.level))
                    h.setLevel(eff)
            root.setLevel(logging.INFO)
        self._handler = _BeatHandler(self)
        root.addHandler(self._handler)
        return self

    def _detach_logging(self) -> None:
        h = getattr(self, "_handler", None)
        if h is not None:
            logging.getLogger().removeHandler(h)
            self._handler = None
        for hh, lvl in getattr(self, "_handler_bumps", []):
            hh.setLevel(lvl)
        self._handler_bumps = []
        prev = getattr(self, "_prev_root_level", None)
        if prev is not None:
            logging.getLogger().setLevel(prev)
            self._prev_root_level = None

    @classmethod
    def for_benchmark(cls, name: str, timeout_s: float = 1800.0) -> "Watchdog":
        """The standard guard of a benchmark entry point on the card."""
        wd = cls(timeout_s, report={"benchmark": name, "value": 0.0})
        return wd.start().attach_to_logging()

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class _BeatHandler(logging.Handler):
    def __init__(self, wd: Watchdog):
        super().__init__()
        self._wd = wd

    def emit(self, record) -> None:  # noqa: D102
        self._wd.alive()
