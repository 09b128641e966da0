"""stella's operations on the engine batches' real tokens (no padding)
over the time some batch was in the engine (the union of each worker's
encode-to-search span) at the f32 peak of 67 TFLOP/s (%): the port
serves the encoder in true f32, TF32 off."""

from portbench.yardstick import peaks, timeline


def read(run):
    lo, hi = run.counters.get("window_perf", (None, None))
    if lo is None:
        return None
    by_thread = {}
    for name, a, b, tid in run.span_log:
        if name in ("encode", "search") and lo <= a <= hi:
            by_thread.setdefault(tid, []).append((a, b, name))
    steps = []
    for spans in by_thread.values():
        spans.sort()
        start = None
        for a, b, name in spans:
            if name == "encode":
                start = a
            elif start is not None:
                steps.append((start, b))
                start = None
    busy = timeline.busy(steps)
    lengths = [t for batch in run.counters.get("tokens", []) for t in batch]
    if busy <= 0 or not lengths:
        return None
    flops = peaks.stella_flops(run.config["encoder"], lengths)
    return 100.0 * flops / (busy * peaks.PEAK_OPS["f32"])
