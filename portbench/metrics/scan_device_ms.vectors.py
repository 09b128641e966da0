"""Mean device milliseconds per search of the IVF-PQ scan (the
program's ``ivfpq.scan`` span: kernel 3, the per-query merge's
segmented sort and gathers), by the program's CUDA events, over the
traced slice's searches."""

from portbench.yardstick.spans import mean, named


def read(run):
    ms = mean(s["device_s"] for s in named(run, "ivfpq.scan"))
    return None if ms is None else 1e3 * ms
