"""Encoder weights on disk: a small safetensors reader and writer.

The JAX package checkpoints its flax tree with orbax; the port keeps
its state dict in one safetensors file instead, and reads HF snapshots
in the same format, with no ``safetensors`` package: an 8-byte
little-endian header length, a JSON header (``name -> {dtype, shape,
data_offsets}``, optional ``__metadata__``), then the raw tensors.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def save_file(path: str | Path, tensors: dict, metadata: dict | None = None) -> None:
    """Write ``tensors`` (name -> tensor on any device) as one
    safetensors file. The data is packed with no gaps (the format's
    rule), widest dtype first, so every tensor starts aligned."""
    header, offset = {}, 0
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of {sorted(_DTYPES)}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, t in items:
            f.write(memoryview(t.detach().contiguous().cpu().view(torch.uint8).numpy()))


def load_file(path: str | Path, select=None) -> dict:
    """One safetensors file -> name -> CPU tensor. The tensors are views
    of a copy-on-write map of the file, paged in as they are read.

    ``select(name, shape) -> (dim, lo, hi) | None`` restores one slice of
    a tensor: ``[lo, hi)`` along ``dim`` 0 is a view of just those rows'
    bytes; along ``dim`` 1 a strided view, whose reads touch only the
    pages that hold the slice's columns. None keeps the whole tensor (the
    counterpart of the JAX package's orbax restore at TP shardings)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_DTYPES)}")
        dtype = _DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        shape = list(info["shape"])
        part = select(name, tuple(shape)) if select is not None else None
        if part is not None and part[0] == 0:
            row = (hi - lo) // max(shape[0], 1)
            lo, hi = lo + part[1] * row, lo + part[2] * row
            shape[0] = part[2] - part[1]
            part = None
        count = (hi - lo) // dtype.itemsize
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + lo) if count
             else torch.empty(0, dtype=dtype)).reshape(shape)
        out[name] = t if part is None else t.narrow(part[0], part[1], part[2] - part[1])
    return out


def load_hf_weights(snapshot: str | Path) -> dict:
    """A HF snapshot's model weights: ``model.safetensors``, or the
    sharded ``model-*-of-*.safetensors`` its
    ``model.safetensors.index.json`` names."""
    snapshot = Path(snapshot)
    single = snapshot / "model.safetensors"
    if single.is_file():
        return load_file(single)
    index = snapshot / "model.safetensors.index.json"
    if index.is_file():
        files = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        out = {}
        for name in files:
            out.update(load_file(snapshot / name))
        return out
    raise FileNotFoundError(f"no model.safetensors or model.safetensors.index.json "
                            f"in {snapshot}")
