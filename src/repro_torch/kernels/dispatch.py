"""Device dispatch shared by the kernel wrappers.

A wrapper takes one of three branches by its inputs' device
(:func:`kernel_device`): ``"cuda"`` launches the Hopper kernel, ``"cpu"``
runs its plain version, and ``"meta"`` (shape-only tensors, the dry run's)
returns empty outputs of the kernel's shapes and dtypes and launches
nothing: a meta tensor has no data to compute on.  Each wrapper is
:func:`counted`: under an active census it reports the kernel's FLOPs and
bytes by formula, the same on every branch.
"""
from __future__ import annotations

import functools

import torch

KINDS = ("cpu", "cuda", "meta")
# () -> the census counting this thread's ops, or None; set by
# repro_torch.roofline.census while a census runs, None otherwise
census_hook = None


def kernel_device(*tensors: torch.Tensor) -> str:
    """'cpu', 'cuda' or 'meta' for a set of tensors on one device; raises
    otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    kind = next(iter(devs)).type
    if kind not in KINDS:
        raise ValueError(f"no kernel path for device type {kind!r}")
    return kind


def counted(name: str, flops=lambda out, *args, **kwargs: 0.0):
    """Decorate a kernel wrapper: under an active census (``census_hook``)
    the census runs the call with its counting paused, and the kernel adds
    ``flops(out, *args, **kwargs)`` FLOPs and the bytes of its tensor
    arguments and outputs (each read or written once)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            c = census_hook() if census_hook is not None else None
            if c is None:
                return fn(*args, **kwargs)
            return c.kernel(name, fn, flops, args, kwargs)
        return run
    return wrap


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Check a kernel argument's dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
