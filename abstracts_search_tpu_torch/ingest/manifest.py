"""OpenAlex snapshot manifest handling.

The port's copy of the JAX package's ``ingest/manifest.py``. The
reference re-fetches ``works/manifest`` on every run, parses the entry
URLs, sorts them, and replaces the local copy only when the content
changed, so downstream stamps rebuild only on real updates. Partitions
are the ``updated_date=YYYY-MM-DD`` path segments.

Fetching is injectable: tests and offline runs use ``file://`` URLs or a
fake fetcher.
"""

from __future__ import annotations

import json
import re
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Callable, Sequence

_PART_RE = re.compile(r"(updated_date=\d{4}-\d{2}-\d{2})")


def default_fetcher(url: str) -> bytes:
    with urllib.request.urlopen(url) as r:  # supports http(s) and file://
        return r.read()


def parse_manifest(raw: bytes) -> list[str]:
    """Extract sorted entry URLs from the manifest JSON (`.entries[].url`)."""
    data = json.loads(raw)
    urls = [e["url"] for e in data.get("entries", [])]
    return sorted(urls)


def fetch_manifest(url: str, fetcher: Callable[[str], bytes] = default_fetcher) -> list[str]:
    return parse_manifest(fetcher(url))


def update_manifest_file(path: str | Path, urls: Sequence[str]) -> bool:
    """Write sorted URLs to `path` only if changed. Returns True if updated.

    The cmp-guarded replacement is what makes quarterly sync incremental:
    unchanged manifest -> unchanged mtimes -> no re-ingest.
    """
    path = Path(path)
    new_text = "\n".join(urls) + "\n" if urls else ""
    if path.exists() and path.read_text() == new_text:
        return False
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(new_text)
    tmp.replace(path)
    return True


def partition_of(url: str) -> str | None:
    """`.../works/updated_date=2024-01-01/part_000.gz` -> `updated_date=2024-01-01`.

    URLs are percent-decoded first (file:// URIs encode `=` as %3D).
    """
    m = _PART_RE.search(urllib.parse.unquote(url))
    return m.group(1) if m else None


def group_by_partition(urls: Sequence[str]) -> dict[str, list[str]]:
    """Partition name -> ordered list of part-file URLs."""
    groups: dict[str, list[str]] = {}
    for u in urls:
        p = partition_of(u)
        if p is not None:
            groups.setdefault(p, []).append(u)
    return groups
