"""The least time of the batches' device work (kernel 1's probe and
kernel 3's scan: each call's least time as counted in the traced slice,
times its calls in the window; plus the f32 rotation, LUTs and bias of
every batch) over the window (%)."""

from portbench.yardstick import peaks


def read(run):
    n = run.counters.get("batches", 0)
    least = peaks.window_least_seconds(run, ["k1", "k3"])
    if not n or not least or "other_least_s" not in run.counters:
        return None
    return 100.0 * (least + n * run.counters["other_least_s"]) / run.window_s
