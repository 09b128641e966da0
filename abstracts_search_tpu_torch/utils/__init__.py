"""Utilities: stage timers and profiler scopes (``trace``)."""

from .trace import StageTimer, profile_scope, timed

__all__ = ["StageTimer", "profile_scope", "timed"]
