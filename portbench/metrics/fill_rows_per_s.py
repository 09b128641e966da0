"""Rows of the whole fill jobs over their seconds (jobs run back to back,
so their seconds are the window)."""


def read(run):
    secs = sum(s for _, s, _ in run.jobs)
    return sum(r for r, _, _ in run.jobs) / secs if secs > 0 else None
