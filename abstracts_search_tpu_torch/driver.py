"""Pipeline policy shared by the build pipeline and the serving engine.
Only the delta-compaction policy is ported so far; the pipeline's
targets (dump, train, fill, sync) are still to be ported."""

from __future__ import annotations


def compaction_due(base_rows: int, delta_rows: int, n_deltas: int, *,
                   max_frac: float, max_deltas: int) -> bool:
    """Fold delta sub-indexes back into the base once they hold more than
    ``max_frac`` of the base rows or number more than ``max_deltas``
    (each delta adds a search fan-out and a RAM-resident id set)."""
    if n_deltas == 0:
        return False
    if n_deltas > max_deltas:
        return True
    return delta_rows > max_frac * max(base_rows, 1)
