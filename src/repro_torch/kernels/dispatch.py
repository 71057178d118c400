"""Device dispatch shared by the kernel wrappers."""
from __future__ import annotations

import torch


def kernel_device(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a set of tensors on one device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel path for device type {kind!r}")
    return kind


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Check a kernel argument's dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
