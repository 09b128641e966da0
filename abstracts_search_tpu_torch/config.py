"""Layered configuration for the framework.

Mirrors the reference's layered config idiom (SURVEY.md §5; reference
`Makefile:4,8-9` — `?=` defaults, optional `env.mk` overrides, per-stage
flag passthroughs, and env vars `SIDECARSEARCH_MODEL`,
`SIDECARSEARCH_TRUST_REMOTE_CODE` at `README.md:60` / `MODEL_NAME`,
`PROMPT_NAME`, `TRUST_REMOTE_CODE` at `README.md:28`):

precedence (highest wins):
  1. explicit CLI flags
  2. environment variables (``ASTPU_*`` plus the reference-compatible names)
  3. an optional ``env.json`` in the working directory (the `env.mk` analog)
  4. built-in defaults (the reference's published values, BASELINE.md)
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any

# Reference-published defaults (BASELINE.md / reference README.md:60).
DEFAULT_SHARD_SIZE = 2_097_152        # rows per parquet shard
DEFAULT_ROW_GROUP_SIZE = 65_536       # rows per parquet row-group
DEFAULT_IVF_CENTROIDS = 65_536        # TRAINFLAGS -c 65536
DEFAULT_EMBED_BATCH = 32              # BUILDFLAGS -b 32
DEFAULT_MODEL = "NovaSearch/stella_en_1.5B_v5"
DEFAULT_QUERY_PROMPT = "s2p_query"
DEFAULT_EMBED_DIM = 1024              # stella MRL head used by the corpus

ENV_FILE = "env.json"


@dataclasses.dataclass
class Config:
    """Global framework configuration."""

    # Paths (reference Makefile:1-2)
    data_dir: str = "abstracts-embeddings/data"
    events_dir: str = "events"
    index_dir: str = "abstracts-faiss/index"
    store_path: str = "data.sqlite"

    # Embedding / model
    model_name: str = DEFAULT_MODEL
    query_prompt: str = DEFAULT_QUERY_PROMPT
    # stella ships remote code; the reference pipeline always runs with
    # SIDECARSEARCH_TRUST_REMOTE_CODE=1 / TRUST_REMOTE_CODE=1
    # (README.md:28,60), so that is the compatible default. Set the env
    # var to 0 to disable.
    trust_remote_code: bool = True
    embed_batch: int = DEFAULT_EMBED_BATCH
    embed_dim: int = DEFAULT_EMBED_DIM
    # orbax checkpoint dir written by `astpu convert-model`; when set,
    # serving/build restore flax weights directly (no torch at runtime)
    ckpt_dir: str = ""
    # opt-in escape hatch: allow convert-model to substitute an UNTRAINED
    # identity-truncation MRL head when the checkpoint ships none.
    # Default False: a missing trained head is a hard error (a silent
    # identity head would produce wrong embeddings with zero errors).
    identity_head: bool = False

    # Shard layout
    shard_size: int = DEFAULT_SHARD_SIZE
    row_group_size: int = DEFAULT_ROW_GROUP_SIZE

    # Index construction
    ivf_centroids: int = DEFAULT_IVF_CENTROIDS
    normalize: bool = True            # TRAINFLAGS -N: unit-sphere inner product
    train_sample: int = 10_000_000    # k-means/PQ training subset size
    tune_sample: int = 100_000        # sample-fill size when tuning unfilled
    # PQ code layout: 128 subquantizers x 4 bits = 64 B/vector, nibble-
    # packed (the production artifact). Set pq_m=64, pq_nbits=8 for the
    # byte-code faiss-classic layout at the same 64 B/vector.
    pq_m: int = 128
    pq_nbits: int = 4
    opq: bool = True
    # "auto" | "device" (lists in device memory) | "host" (memmap) |
    # "hybrid" (hottest lists on the device up to index_hot_bytes, cold
    # tail from the memmap). The port serves "device" ("auto" resolves
    # to it); "host" and "hybrid" are still to be ported.
    index_storage: str = "auto"
    index_hot_bytes: int = 1 << 30
    # packed-list segment rows: smaller segments shed per-list tail
    # padding at the cost of more scan slots per probe; 256 is the
    # production point
    index_seg_size: int = 256
    # delta compaction policy: incremental fills accumulate delta
    # sub-indexes (each adds a search fan-out round trip and a
    # RAM-resident id set); when delta rows exceed this fraction of the
    # base OR the delta count exceeds compact_max_deltas, the driver
    # folds them back with a full re-dump + refill (auto_compact=False
    # defers to an explicit `astpu index compact`)
    compact_max_delta_frac: float = 0.10
    compact_max_deltas: int = 4
    auto_compact: bool = True

    # Ingest
    manifest_url: str = "https://openalex.s3.amazonaws.com/data/works/manifest"
    language: str = "en"
    # download-ahead buffer between the fetcher thread and the filter/
    # embed pipeline (the `mbuffer -m 4G` role, reference Makefile:62)
    ingest_buffer_bytes: int = 256 << 20

    def replace(self, **kw: Any) -> "Config":
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(self, **kw)


_ENV_MAP = {
    # ASTPU-native names
    "ASTPU_MODEL": ("model_name", str),
    "ASTPU_QUERY_PROMPT": ("query_prompt", str),
    "ASTPU_DATA_DIR": ("data_dir", str),
    "ASTPU_INDEX_DIR": ("index_dir", str),
    "ASTPU_STORE": ("store_path", str),
    "ASTPU_EMBED_DIM": ("embed_dim", int),
    "ASTPU_TRAIN_SAMPLE": ("train_sample", int),
    "ASTPU_TUNE_SAMPLE": ("tune_sample", int),
    "ASTPU_CKPT": ("ckpt_dir", str),
    "ASTPU_INGEST_BUFFER_BYTES": ("ingest_buffer_bytes", int),
    "ASTPU_INDEX_STORAGE": ("index_storage", str),
    "ASTPU_INDEX_HOT_BYTES": ("index_hot_bytes", int),
    "ASTPU_INDEX_SEG_SIZE": ("index_seg_size", int),
    "ASTPU_COMPACT_MAX_DELTA_FRAC": ("compact_max_delta_frac", float),
    "ASTPU_COMPACT_MAX_DELTAS": ("compact_max_deltas", int),
    "ASTPU_AUTO_COMPACT": ("auto_compact", lambda s: s not in ("", "0")),
    # Reference-compatible names (README.md:28,60)
    "SIDECARSEARCH_MODEL": ("model_name", str),
    "SIDECARSEARCH_TRUST_REMOTE_CODE": ("trust_remote_code", lambda s: s not in ("", "0")),
    "MODEL_NAME": ("model_name", str),
    "PROMPT_NAME": ("query_prompt", str),
    "TRUST_REMOTE_CODE": ("trust_remote_code", lambda s: s not in ("", "0")),
}


def load_config(cwd: str | os.PathLike | None = None, **overrides: Any) -> Config:
    """Build a Config from defaults <- env.json <- environment <- overrides."""
    cfg = Config()

    root = Path(cwd) if cwd is not None else Path.cwd()
    env_file = root / ENV_FILE
    if env_file.is_file():
        data = json.loads(env_file.read_text())
        known = {f.name for f in dataclasses.fields(Config)}
        cfg = cfg.replace(**{k: v for k, v in data.items() if k in known})

    env_kw: dict[str, Any] = {}
    for var, (field, conv) in _ENV_MAP.items():
        if var in os.environ:
            env_kw[field] = conv(os.environ[var])
    cfg = cfg.replace(**env_kw)

    return cfg.replace(**overrides)
