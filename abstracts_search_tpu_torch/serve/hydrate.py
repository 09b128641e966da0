"""OpenAlex metadata hydration client.

The index holds no publication data of its own: titles, years, authors
and DOIs come from the OpenAlex works API at query time. Lookups go in
batches of ``BATCH`` ids; the fetcher is injectable, so tests and
offline deployments run against a stub.
"""

from __future__ import annotations

import json
import logging
import urllib.parse
import urllib.request
from typing import Callable, Sequence

logger = logging.getLogger(__name__)

API_BASE = "https://api.openalex.org/works"
BATCH = 50  # OpenAlex filter list limit


def _default_fetcher(url: str) -> bytes:
    req = urllib.request.Request(url, headers={"User-Agent": "abstracts-search-tpu"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _short_id(work_id: str) -> str:
    """https://openalex.org/W123 -> W123 (the API filter takes short ids)."""
    return work_id.rsplit("/", 1)[-1]


class OpenAlexClient:
    def __init__(self, fetcher: Callable[[str], bytes] | None = None):
        self.fetcher = fetcher if fetcher is not None else _default_fetcher

    def get_works(self, ids: Sequence[str]) -> dict[str, dict]:
        """id -> metadata dict (title, year, authors, doi). Missing or
        failed lookups simply don't appear in the result."""
        out: dict[str, dict] = {}
        for lo in range(0, len(ids), BATCH):
            chunk = ids[lo : lo + BATCH]
            flt = "openalex:" + "|".join(_short_id(i) for i in chunk)
            url = f"{API_BASE}?filter={urllib.parse.quote(flt)}&per-page={len(chunk)}"
            try:
                data = json.loads(self.fetcher(url))
            except Exception as e:  # noqa: BLE001 — hydration is best effort
                logger.warning("hydration failed for %d ids: %s", len(chunk), e)
                continue
            for w in data.get("results", []):
                out[w["id"]] = {
                    "title": w.get("title"),
                    "publication_year": w.get("publication_year"),
                    "doi": w.get("doi"),
                    "authors": [
                        a.get("author", {}).get("display_name")
                        for a in w.get("authorships", [])[:8]
                    ],
                }
        return out
