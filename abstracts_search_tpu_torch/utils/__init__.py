"""Utilities: the tracer, its stage timer and profiler scope
(``trace``), the bounded iterator prefetch of the index fill and the
ingest (``prefetch``), and the deadline watchdog of unattended runs
(``watchdog``)."""

from .prefetch import prefetch_iterator
from .trace import StageTimer, profile_scope
from .watchdog import Watchdog

__all__ = ["StageTimer", "Watchdog", "prefetch_iterator", "profile_scope"]
