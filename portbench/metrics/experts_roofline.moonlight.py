"""The grouped expert kernel's share of its roofline over its calls in
the traced slice (%): ``yardstick.peaks.roofline_share`` of the calls
``OpRanges`` timed by CUDA events, each counted by
``yardstick.moonlight.experts_cost`` (bf16 operations of every
token-expert pair, against each touched expert's weights and the rows in
and out once)."""

from portbench.yardstick.peaks import roofline_share


def read(run):
    return roofline_share(run, "experts")
