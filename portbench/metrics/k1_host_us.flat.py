"""Mean host microseconds of kernel 1's wrapper per call (the program's
``topk`` span: the wrapper's entry to its launcher's return) over the
traced slice's calls."""

from portbench.yardstick.spans import mean, named


def read(run):
    us = mean(s["host_s"] for s in named(run, "topk"))
    return None if us is None else 1e6 * us
