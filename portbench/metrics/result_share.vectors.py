"""The share of each engine batch spent after ``IVFPQIndex.search``
returns (%): the engine's id resolution and result rows, from the
synchronising spans around the batch and around the index search."""


def read(run):
    batch = sum(b - a for a, b in run.spans("batch"))
    index = sum(b - a for a, b in run.spans("index"))
    return 100.0 * (batch - index) / batch if batch > 0 else None
