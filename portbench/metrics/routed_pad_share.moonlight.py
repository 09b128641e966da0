"""Padding among the tokens the expert layers computed in the window
(%): the backbone's ``last_moe_stats`` after each forward, summed on the
card and read once the window has closed."""


def read(run):
    tokens = run.counters.get("moe_tokens")
    if not tokens:
        return None
    return 100.0 * run.counters["moe_pad_tokens"] / tokens
