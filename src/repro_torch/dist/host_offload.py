"""Fast/slow memory tiers for whole tensors — NeoMem's tiers (port of
``repro/dist/host_offload.py``).

Device memory is the fast tier (DRAM in the paper), pinned host memory the
slow tier (CXL-attached memory).  ``to_slow_tier`` / ``to_fast_tier`` move
a tensor between them with an explicit copy, the software counterpart of a
page migration; the values are bitwise unchanged either way.  On the CPU
there is no second tier: the move is logical (the tensor itself), as the
reference's fallback on a backend without memory kinds, so tiering code
runs unchanged everywhere.

:class:`Prefetch` issues the promotions of a tree on a side CUDA stream and
hands the tree over at :meth:`Prefetch.wait`, so the copies overlap
whatever the compute stream runs meanwhile (the reference's
prefetch-before-consume, which XLA's scheduler arranges by itself).
"""
from __future__ import annotations

import weakref

import torch

def supports_memory_kinds(device=None) -> bool:
    """True where a distinct host tier exists to offload into: a CUDA
    device (the current one by default)."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def pinned_zeros(shape, dtype) -> torch.Tensor:
    """A zeroed host tensor whose pages are locked for DMA by
    ``cudaHostRegister`` (unregistered when the tensor is collected).
    Unlike ``pin_memory=True``, whose caching allocator keeps freed blocks
    (rounded up in size) for reuse, this returns the pages to the system
    when the tensor goes: the slow tier's vectors are few and large."""
    t = torch.zeros(shape, dtype=dtype)
    cudart = torch.cuda.cudart()
    err = int(cudart.cudaHostRegister(t.data_ptr(), t.numel() * t.element_size(), 0))
    if err:
        raise RuntimeError(f"cudaHostRegister failed with CUDA error {err}")
    weakref.finalize(t, cudart.cudaHostUnregister, t.data_ptr())
    return t


def to_slow_tier(x: torch.Tensor, mesh=None, spec=None, *, out=None):
    """Demote: a pinned host copy of a CUDA tensor (into ``out``, a pinned
    tensor of its shape, when given), issued on the current stream without
    blocking the host; a CPU tensor is returned as it is.  ``spec`` (the
    tensor's placement) is kept for the reference's signature: a rank moves
    its own block."""
    if x.device.type != "cuda":
        return x
    if out is None:
        out = pinned_zeros(x.shape, x.dtype)
    out.copy_(x, non_blocking=True)
    return out


def to_fast_tier(x: torch.Tensor, mesh=None, spec=None):
    """Promote: the tensor on the mesh's device (the current CUDA device
    without a mesh); a tensor already there, or any tensor where the mesh
    is on the CPU, is returned as it is."""
    if mesh is not None:
        dev = mesh.device
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        return x
    if dev.type != "cuda" or x.device == dev:
        return x
    return x.to(dev, non_blocking=True)


class Prefetch:
    """``to_fast_tier`` over the pinned host tensors of a dict, issued on a
    side CUDA
    stream after the work already queued on the current stream (so that it
    reads the host copies the previous demotion wrote).  :meth:`wait`
    makes the current stream wait for the copies and returns the dict of
    promoted tensors; ``start`` / ``end`` (CUDA events on the side stream,
    None on the CPU) time the copies and ``waited`` marks where the current
    stream reached :meth:`wait`.  ``source`` is the dict it promotes from,
    whose pinned tensors a demotion may write into again."""

    def __init__(self, tree: dict, mesh=None):
        self.source = tree
        self.start = self.end = self.waited = None
        slow = [k for k, v in tree.items() if v.device.type == "cpu" and v.is_pinned()]
        if not slow:
            self._out = dict(tree)
            return
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            self.start.record()
            self._out = {k: (to_fast_tier(v, mesh) if k in slow else v)
                         for k, v in tree.items()}
            self.end.record()
        for k in slow:      # allocated on the side stream, used on the current
            self._out[k].record_stream(cur)

    def wait(self) -> dict:
        """The promoted dict, once (the prefetch keeps no reference to it)."""
        if self.end is not None:
            self.waited = torch.cuda.Event(enable_timing=True)
            self.waited.record()
            torch.cuda.current_stream().wait_event(self.end)
        out, self._out = self._out, None
        return out
