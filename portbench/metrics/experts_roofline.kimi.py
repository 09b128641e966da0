"""The grouped expert kernel's share of its roofline over its calls in
the Kimi Linear cell's traced slice (%), counted as
``experts_roofline.moonlight`` counts them (``yardstick.moonlight.
experts_cost``): over the held experts with rows and the held
token-expert pairs, the calls timed by CUDA events."""

from portbench.yardstick.peaks import roofline_share


def read(run):
    return roofline_share(run, "experts")
