"""The host pack's share of the fill jobs' seconds (%): ``pack_s`` of
``IVFPQIndex.fill_stats`` over the job seconds."""


def read(run):
    secs = sum(s for _, s, _ in run.jobs)
    return 100.0 * sum(st.get("pack_s", 0.0) for _, _, st in run.jobs) / secs if secs else None
