"""The share of the fill jobs' seconds spent in the host's normalisation of each row group
(%): ``normalize_s`` of ``IVFPQIndex.fill_stats``, the host seconds of the
program's ``fill.normalize`` spans, over the whole jobs' seconds."""


def read(run):
    secs = sum(s for _, s, _ in run.jobs)
    stats = [st for _, _, st in run.jobs]
    if secs <= 0 or not stats or any("normalize_s" not in st for st in stats):
        return None
    return 100.0 * sum(st["normalize_s"] for st in stats) / secs
