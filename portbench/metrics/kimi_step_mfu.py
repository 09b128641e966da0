"""Kimi Linear's operations on the real tokens of every call in the
window (``yardstick.kimi_linear.flops``: 2 per active weight a token,
KDA's recurrence, MLA's causal q.k and p.v, the MRL head; of the routed
experts, the held pairs only, at the share of the routed pairs that the
traced window's forwards held) over the window at the bf16 peak of 989
TFLOP/s (%)."""

from portbench.yardstick import kimi_linear as yk
from portbench.yardstick import peaks


def read(run):
    lengths = run.counters.get("tokens")
    pairs = run.counters.get("moe_pairs")
    if not lengths or not pairs or not run.window_s > 0:
        return None
    held = run.counters["moe_held_pairs"] / pairs
    flops = yk.flops(yk.encoder(run.config), lengths, held)
    return 100.0 * flops / (run.window_s * peaks.PEAK_OPS["bf16"])
