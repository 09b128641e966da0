"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and no
PyTorch headers, so one ``nvcc`` takes seconds. All sources compile in
parallel (one ``nvcc`` process each) at the first CUDA use, into
``build/kernels/<hash>/`` at the repository root, keyed by a hash of
the sources and the flags: an edited source rebuilds, an unchanged one
is reused. A failed build raises. nvcc's report (``-Xptxas -v``: each
kernel function's registers, shared memory and spills) is kept beside
each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds the last build took (0.0 when every library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every kernel source that is not built yet (all nvcc runs
    started together), then load each library. Idempotent."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        out = _build_dir()
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in _sources():
            so = out / f"{src.stem}.so"
            if so.exists():
                continue
            tmp = out / f"{src.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, so, tmp, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            else:
                so.with_suffix(".log").write_text(log)
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        build_seconds = time.perf_counter() - t0 if procs else 0.0
        for src in _sources():
            _libs[src.stem] = ctypes.CDLL(str(out / f"{src.stem}.so"))
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes of each kernel function of library
    ``name``, from its build's ``-Xptxas -v`` report: mangled name ->
    {"registers", "spill_stores", "spill_loads"}."""
    log = Path(library(name)._name).with_suffix(".log").read_text()
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
