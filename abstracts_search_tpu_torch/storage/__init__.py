"""Host-side artifacts the serving path reads: the position -> id map
over ``ids.parquet`` and its binary sidecar (``idmap``); chunked device
sources of the index build (``virtual``)."""

from .idmap import IdMap, build_sidecar
from .virtual import RotatedDeviceSource

__all__ = ["IdMap", "RotatedDeviceSource", "build_sidecar"]
