"""Online serving: query encode -> IVF-PQ search on the card -> ids.

``SearchEngine`` (engine.py), the micro-batcher (batcher.py) and the
stdlib HTTP app (app.py).
"""

from .engine import SearchEngine

__all__ = ["SearchEngine"]
