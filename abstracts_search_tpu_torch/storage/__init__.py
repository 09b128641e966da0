"""Host-side artifacts the serving path reads: the position -> id map
over ``ids.parquet`` and its binary sidecar (``idmap``)."""

from .idmap import IdMap, build_sidecar

__all__ = ["IdMap", "build_sidecar"]
