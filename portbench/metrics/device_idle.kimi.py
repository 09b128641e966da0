"""The share of the traced slice's wall time in which no kernel or copy
ran on the device (%): the union of the profiler's device intervals."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
