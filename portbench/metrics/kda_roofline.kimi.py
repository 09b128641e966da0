"""The KDA kernel's share of its roofline over its calls in the traced
slice (%): ``yardstick.peaks.roofline_share`` of the calls ``OpRanges``
timed by CUDA events, each counted by ``yardstick.kimi_linear.kda_cost``
(the recurrence's 7 d^2 operations a token and head, bf16, against q,
k, v, the f32 log-decays and beta in and o out once)."""

from portbench.yardstick.peaks import roofline_share


def read(run):
    return roofline_share(run, "kda")
