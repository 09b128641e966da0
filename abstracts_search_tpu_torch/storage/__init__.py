"""Host-side storage: the SQLite embedding store (``sqlite_store``),
parquet shard I/O (``shards``), the lazy ``ids.parquet`` id map and its
binary sidecar (``idmap``), and the virtual corpus with the chunked
device sources of the index build (``virtual``). pyarrow is imported
only where parquet is read or written."""

from .idmap import IdMap, build_sidecar
from .shards import ShardReader, ShardWriter, dump_store_to_shards, load_shards_to_store
from .sqlite_store import EmbeddingStore, init_store
from .virtual import (RotatedDeviceSource, VirtualShardReader, VirtualSpec, open_data_source,
                      write_spec)

__all__ = ["EmbeddingStore", "IdMap", "RotatedDeviceSource", "ShardReader", "ShardWriter",
           "VirtualShardReader", "VirtualSpec", "build_sidecar", "dump_store_to_shards",
           "init_store", "load_shards_to_store", "open_data_source", "write_spec"]
