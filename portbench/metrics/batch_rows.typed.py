"""Requests per engine batch in the window (``MicroBatcher.stats``)."""


def read(run):
    b = run.counters.get("batches", 0)
    return run.counters["batch_requests"] / b if b else None
