"""Device resolution and the f32 precision contract.

Every f32 product whose contract is exactness (the probe's rotation,
the q . c_list bias, the PQ lookup tables) must run in true IEEE f32.
PyTorch's matmul default is already f32, but cuDNN's is TF32, and any
caller may flip either flag; the package pins both off at import and
the index asserts them before it searches.
"""

from __future__ import annotations

import torch


def set_exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def assert_exact_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.backends.cudnn.allow_tf32); the index's f32 products "
            "must run in full f32")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. A CUDA device without a card
    raises: nothing silently falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch route")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
