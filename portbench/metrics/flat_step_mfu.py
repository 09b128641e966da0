"""The least time of the batches' device work (kernel 1 over the shard:
each call's least time as counted in the traced slice, times its calls
in the window) over the window (%)."""

from portbench.yardstick import peaks


def read(run):
    least = peaks.window_least_seconds(run, ["k1"])
    return 100.0 * least / run.window_s if least else None
