"""The least time of a fill job's device work (the f32 rotation, kernel
1 at k 1 on bf16 operands, the f32 residual codes, the outputs:
``yardstick.peaks.fill_costs``) over the job's seconds (%)."""


def read(run):
    secs = sum(s for _, s, _ in run.jobs)
    if "job_least_s" not in run.counters or secs <= 0:
        return None
    return 100.0 * run.counters["job_least_s"] * len(run.jobs) / secs
