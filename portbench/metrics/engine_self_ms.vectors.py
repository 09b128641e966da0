"""Mean self time of the engine per batch (ms): the program's
``engine.search`` span less the part its child, ``ivfpq.search``,
covers (the engine's rows, merge and dicts), over the traced slice's
batches."""

from portbench.yardstick.spans import mean, named


def read(run):
    ms = mean(s["self_s"] for s in named(run, "engine.search"))
    return None if ms is None else 1e3 * ms
