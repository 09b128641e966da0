"""OpenAlex works filter: {works JSONL} -> {"id", "document"} JSONL.

The port's copy of the JAX package's ``ingest/oa_filter.py``. Two
interchangeable implementations of one contract (the reference's native
filter: drop non-English works, drop null or empty abstracts, rebuild
the abstract text from the inverted index, prepend the title when
present):

- the native C++ filter (``cpp/oa_jsonl_filter.cc``) as a subprocess
  pipe (``OaJsonlFilter``, ``filter_stream_native``): the production
  path, a separate process that overlaps parsing with embedding;
- ``filter_works_lines``: pure Python with the same semantics, the
  differential-testing oracle.

``ensure_filter_built`` compiles the C++ source with ``g++ -O2
-std=c++17`` at first use into ``build/native/`` at the repository root
(git-ignored), keyed by a hash of the source, as ``ops/_build.py``
builds the kernels. It never writes under ``cpp/``. A failed build
raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Iterator

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "cpp" / "oa_jsonl_filter.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17"]

_lock = threading.Lock()


def ensure_filter_built() -> Path:
    """Build the native filter if this source is not built yet; returns
    the binary's path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    binary = BUILD_DIR / f"oa_jsonl_filter-{h.hexdigest()[:16]}"
    with _lock:
        if binary.exists():
            return binary
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native OpenAlex filter cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = binary.with_name(f"{binary.name}.{os.getpid()}.tmp")
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, binary)
    return binary


def _reconstruct_abstract(inv_index: dict) -> str:
    """positions -> words, later duplicates win, join non-empty slots."""
    slots: dict[int, str] = {}
    for word, positions in inv_index.items():
        for pos in positions:
            if isinstance(pos, int) and 0 <= pos < (1 << 20):
                slots[pos] = word
    return " ".join(slots[i] for i in sorted(slots) if slots[i] != "")


def filter_record(rec: dict) -> dict | None:
    """Apply the drop/reconstruct rules to one parsed record."""
    if "language" in rec:
        if rec["language"] is None or rec["language"] != "en":
            return None
    inv = rec.get("abstract_inverted_index")
    if not inv:  # absent, null, or empty object
        return None
    abstract = _reconstruct_abstract(inv)
    if not abstract:
        return None
    work_id = rec.get("id")
    if not work_id:
        return None
    title = rec.get("title")
    document = f"{title} {abstract}" if title is not None else abstract
    return {"id": work_id, "document": document}


def filter_works_lines(lines: Iterable[str]) -> Iterator[dict]:
    """Pure-Python implementation (also the test oracle)."""
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # skip malformed (the native filter warns + skips too)
        if not isinstance(rec, dict):
            continue  # top-level null/array/scalar: not a work record
        out = filter_record(rec)
        if out is not None:
            yield out


class OaJsonlFilter:
    """Subprocess wrapper around the native filter.

    Usage::

        with OaJsonlFilter() as f:
            records = f.filter_text(raw_jsonl)
    """

    def __init__(self):
        self.proc = subprocess.Popen([str(ensure_filter_built())], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)

    def filter_text(self, text: str) -> list[dict]:
        """One-shot filtering of a complete input."""
        out, _ = self.proc.communicate(text.encode("utf-8"))
        return [json.loads(line) for line in out.decode("utf-8").splitlines() if line]

    def __enter__(self) -> "OaJsonlFilter":
        return self

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def filter_stream_native(byte_chunks: Iterable[bytes], batch_size: int = 1024
                         ) -> Iterator[list[dict]]:
    """Stream raw JSONL bytes through the native filter, yielding batches.

    A background writer thread feeds the subprocess, so its pipes cannot
    deadlock (the filter is a streaming Unix filter, like the
    reference's ``... | ./oa_jsonl | ...`` stage)."""
    proc = subprocess.Popen([str(ensure_filter_built())], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)

    def _feed():
        try:
            for chunk in byte_chunks:
                proc.stdin.write(chunk)
        finally:
            proc.stdin.close()

    t = threading.Thread(target=_feed, daemon=True)
    t.start()

    batch: list[dict] = []
    for line in proc.stdout:
        try:
            batch.append(json.loads(line))
        except json.JSONDecodeError:
            continue
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
    t.join()
    proc.wait()
