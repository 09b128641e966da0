"""Utilities: stage timers and profiler scopes (``trace``), and the
bounded iterator prefetch of the index fill (``prefetch``)."""

from .prefetch import prefetch_iterator
from .trace import StageTimer, profile_scope, timed

__all__ = ["StageTimer", "prefetch_iterator", "profile_scope", "timed"]
