"""The share of the fill jobs' seconds spent in the host-to-card copies of the row groups
(%): ``upload_s`` of ``IVFPQIndex.fill_stats``, the host seconds of the
program's ``fill.upload`` spans, over the whole jobs' seconds."""


def read(run):
    secs = sum(s for _, s, _ in run.jobs)
    stats = [st for _, _, st in run.jobs]
    if secs <= 0 or not stats or any("upload_s" not in st for st in stats):
        return None
    return 100.0 * sum(st["upload_s"] for st in stats) / secs
