"""The tuned operating point, ``params.json`` (``nprobe``, ``k``, the
recall it reached). Tuning itself is still to be ported; the serving
path reads the file the JAX package's tune writes."""

from __future__ import annotations

import json
from pathlib import Path


def write_params(path: str | Path, params: dict) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(params, indent=2))


def read_params(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())
