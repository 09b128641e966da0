"""The encoder call's share of the engine batches' time (%): the
synchronising spans around ``encode_queries`` over those spans and the
spans around ``search_batch_encoded``, inside the window."""


def read(run):
    lo, hi = run.counters.get("window_perf", (None, None))
    if lo is None:
        return None
    inside = lambda name: sum(b - a for a, b in run.spans(name) if lo <= a <= hi)  # noqa: E731
    enc, search = inside("encode"), inside("search")
    return 100.0 * enc / (enc + search) if enc + search > 0 else None
