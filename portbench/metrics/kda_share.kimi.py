"""The KDA layers' share of the encoder's device time in the traced
slice (%): the program's ``kda.attention`` spans (each KDA mixer, its
projections to ``o_proj``) over its ``encoder.forward`` spans, by their
CUDA events. None where the program has no such spans."""

from portbench.yardstick.spans import named


def read(run):
    fwd = sum(s["device_s"] for s in named(run, "encoder.forward"))
    kda = sum(s["device_s"] for s in named(run, "kda.attention"))
    return 100.0 * kda / fwd if fwd > 0 else None
