"""Peaks of one NVIDIA H100 SXM and the operations and bytes of each
part of the work, counted from shapes.

Peaks are NVIDIA's data sheet figures (dense, at the 700 W limit). A
roofline share is the least time the chip could take (the larger of
operations over the peak of their type and bytes over the HBM rate)
over the time measured. Bytes count each input read once and each output
written once, whatever a kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def least_seconds(ops: float, moved: float, kind: str) -> tuple:
    """-> (seconds, "operations" | "bytes"): the larger of the two."""
    t_ops = ops / PEAK_OPS[kind]
    t_bytes = moved / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def topk_cost(q: int, n: int, d: int, k: int, elt: int) -> tuple:
    """Kernel 1 (a streaming top-k of q . x^T): -> (ops, bytes). The
    queries and the corpus read once, (value, row) pairs written."""
    return 2.0 * q * n * d, float(elt * (q + n) * d + 8 * q * k)


def adc_cost(distinct_segs: int, seg_bytes: int, n_slots: int, q: int, m: int, ksub: int,
             seg: int, kp: int) -> tuple:
    """Kernel 3 (the fused ADC scan and per-slot top-kp): -> (ops, bytes).
    Operations: one LUT add per code of every scanned row (f32). Bytes:
    each DISTINCT probed segment once, however many queries probe it, the
    LUTs, the slot arrays (segment, query, live rows) and the outputs."""
    ops = float(n_slots) * seg * m
    moved = (float(distinct_segs) * seg_bytes + 4.0 * q * m * ksub + 12.0 * n_slots
             + 8.0 * n_slots * kp)
    return ops, moved


def stella_matmul_params(enc: dict) -> int:
    """Weights that multiply each token: every projection of every layer
    and the MRL head (the embedding is a gather)."""
    h, inter, hd = enc["hidden_size"], enc["intermediate_size"], enc["head_dim"]
    heads, kv = enc["num_attention_heads"], enc["num_key_value_heads"]
    per_layer = h * (heads + 2 * kv) * hd + heads * hd * h + 3 * h * inter
    return enc["num_hidden_layers"] * per_layer + h * enc["mrl_dim"]


def stella_flops(enc: dict, lengths) -> float:
    """Operations of stella over sequences of these real lengths: 2 per
    matmul weight per token, plus q.k and p.v over each sequence (4 t^2
    head_dim per head and layer); the MRL head runs once per sequence."""
    w = stella_matmul_params(enc) - enc["hidden_size"] * enc["mrl_dim"]
    per_att = 4.0 * enc["num_attention_heads"] * enc["head_dim"] * enc["num_hidden_layers"]
    return float(sum(2.0 * w * t + per_att * t * t + 2.0 * enc["hidden_size"] * enc["mrl_dim"]
                     for t in lengths))


def fill_costs(n: int, d: int, n_lists: int, m: int, ksub: int, code_bytes: int) -> list:
    """The device parts of encoding ``n`` rows: -> [(name, ops, bytes,
    kind)]: the f32 rotation, kernel 1 at k 1 on bf16 operands, the
    residual and PQ argmin (f32), and the codes and assignments out."""
    dsub = d // m
    return [
        ("rotate", 2.0 * n * d * d, 4.0 * (2 * n * d + d * d), "f32"),
        ("assign", 2.0 * n * n_lists * d, 2.0 * (n + n_lists) * d + 8.0 * n, "bf16"),
        ("pq", 2.0 * n * m * ksub * dsub + 3.0 * n * d,
         4.0 * (2 * n * d + m * ksub * dsub) + 8.0 * n * m, "f32"),
        ("out", 0.0, float(n) * (code_bytes + 8), "f32"),
    ]


def traced_calls(run, name: str) -> list:
    """[(ops, bytes, kind, device seconds)] of op ``name``'s calls in the
    traced slice: each counted from its arguments, timed on the device."""
    costs, secs = run.op_costs.get(name, {}), run.op_device_s.get(name, {})
    return [costs[i] + (secs[i],) for i in sorted(costs.keys() & secs.keys())]


def roofline_share(run, name: str):
    """The least time of op ``name``'s calls in the traced slice over
    their device time (CUDA events around each call, on its stream), in
    %; None where no call was timed."""
    calls = traced_calls(run, name)
    dev = sum(c[3] for c in calls)
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(least_seconds(o, m, k)[0] for o, m, k, _ in calls) / dev


def window_least_seconds(run, names) -> float | None:
    """The least time of every call of the ops ``names`` in the window:
    each op's mean least time per traced call times its calls in the
    window; None where an op has no traced call."""
    total = 0.0
    for name in names:
        calls = run.op_costs.get(name, {})
        n = run.counters.get("calls", {}).get(name, 0)
        if not calls:
            return None
        least = [least_seconds(*c)[0] for c in calls.values()]
        total += n * sum(least) / len(least)
    return total
