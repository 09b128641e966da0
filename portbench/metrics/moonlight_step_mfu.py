"""Moonlight's operations on the real tokens of every call in the window
(``yardstick.moonlight.flops``: 2 per active weight a token, attention's
q.k and p.v, the MRL head) over the window at the bf16 peak of 989
TFLOP/s (%)."""

from portbench.yardstick import peaks
from portbench.yardstick import moonlight as ym


def read(run):
    lengths = run.counters.get("tokens")
    if not lengths or not run.window_s > 0:
        return None
    flops = ym.flops(ym.encoder(run.config), lengths)
    return 100.0 * flops / (run.window_s * peaks.PEAK_OPS["bf16"])
