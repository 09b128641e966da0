"""Online serving: query encode -> IVF-PQ search on the card -> ids.

``SearchEngine`` (engine.py; ``from_artifacts`` builds it from an
artifact directory), the micro-batcher (batcher.py), the stdlib HTTP app
(app.py, ``run_server``) and OpenAlex hydration (hydrate.py).
"""

from .engine import SearchEngine

__all__ = ["SearchEngine"]
