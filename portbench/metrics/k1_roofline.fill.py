"""Kernel 1's share of its roofline over its calls in the traced slice
(%): ``yardstick.peaks.roofline_share``."""

from portbench.yardstick.peaks import roofline_share


def read(run):
    return roofline_share(run, "k1")
