"""The expert layers' share of the encoder's device time in the traced
slice (%): the program's ``moe.route`` and ``moe.experts`` spans over its
``encoder.forward`` spans, by their CUDA events. None where the program
has no such spans."""

from portbench.yardstick.spans import named


def read(run):
    fwd = sum(s["device_s"] for s in named(run, "encoder.forward"))
    moe = sum(s["device_s"] for name in ("moe.route", "moe.experts") for s in named(run, name))
    return 100.0 * moe / fwd if fwd > 0 else None
