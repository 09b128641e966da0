"""Mean live (query, segment) slots scanned per search
(``IVFPQIndex.last_scan_stats``)."""


def read(run):
    s = run.counters.get("live_slots")
    return sum(s) / len(s) if s else None
