"""The program's own spans in a traced run (the tracer of
``abstracts_search_tpu_torch.utils.trace``).

The tracer records while a profiler runs, so after a traced run it
holds the spans of the traced slice (of the traced job in the fill).
The first reader that asks drains it, and the spans stay on the run
for the others. A program whose tracer has no ``collect`` gives None,
and so do the readers.
"""

from __future__ import annotations

from abstracts_search_tpu_torch.utils import trace


def program(run):
    """-> the run's spans (dicts as ``trace.collect`` gives them), or None."""
    if not hasattr(run, "program"):
        collect = getattr(trace, "collect", None)
        run.program = None if collect is None else collect()
    return run.program


def named(run, name: str) -> list:
    """The run's spans called ``name`` (none without the program's spans)."""
    return [s for s in program(run) or () if s["name"] == name]


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None
