"""Sketch histogram through the Hopper histogram unit (``csrc/cms_hist.cu``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core import sketch as sk
from repro_torch.core.sketch import HIST_BINS, SketchParams, SketchState
from repro_torch.kernels import _lib
from repro_torch.kernels.cms_hist.ref import hist_ref
from repro_torch.kernels.dispatch import kernel_device, require


def hist_kernel(counts_row0, epochs_row0, cur_epoch, edges):
    """(W,) int32 counters + (W,) uint8 tags + () uint8 epoch + (65,) int32
    edges -> (64,) int32 histogram of the live counters."""
    if kernel_device(counts_row0, epochs_row0, cur_epoch, edges) == "cpu":
        return hist_ref(counts_row0, epochs_row0, cur_epoch, edges)
    w = counts_row0.shape[0]
    require(counts_row0, "counts_row0", torch.int32, (w,))
    require(epochs_row0, "epochs_row0", torch.uint8, (w,))
    require(cur_epoch, "cur_epoch", torch.uint8, ())
    require(edges, "edges", torch.int32, (HIST_BINS + 1,))
    out = torch.empty((HIST_BINS,), dtype=torch.int32, device=counts_row0.device)
    err = _lib.lib().cms_hist_launch(
        counts_row0.data_ptr(), epochs_row0.data_ptr(), cur_epoch.data_ptr(),
        edges.data_ptr(), out.data_ptr(), w, _lib.stream_ptr(out.device))
    _lib.check(err, "cms_hist")
    hist_kernel.launches += 1
    return out


hist_kernel.launches = 0


@functools.lru_cache(maxsize=None)
def device_edges(counter_bits: int, device: torch.device) -> torch.Tensor:
    """``core.sketch.hist_edges(counter_bits)`` as an int32 tensor on
    ``device``, built and copied there once; every caller shares it, and the
    kernel only reads it."""
    return torch.as_tensor(sk.hist_edges(counter_bits), device=device)


def sketch_histogram(state: SketchState, params: SketchParams) -> torch.Tensor:
    """Drop-in for ``core.sketch.sketch_histogram`` through the kernel."""
    edges = device_edges(params.counter_bits, state.counts.device)
    return hist_kernel(state.counts[0], state.epochs[0], state.cur_epoch, edges)
