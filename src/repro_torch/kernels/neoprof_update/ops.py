"""Sketch update with the Hopper kernels: wrappers and the full verb.

``sketch_update_kernel`` / ``sketch_mark_hot_kernel`` launch
``csrc/neoprof_update.cu`` on CUDA tensors and run the plain versions on CPU
tensors.  :func:`sketch_update` is a drop-in for
:func:`repro_torch.core.sketch.sketch_update` that puts the heavy per-entry
work in those kernels and keeps the cheap cross-lane reduction (min over
lanes, hot filter, the O(S^2) first-occurrence dedup) in plain torch, as
the reference keeps it in jnp around its Pallas kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import (PAGE_ID_BITS, SketchParams, SketchState,
                                     _first_occurrence)
from repro_torch.kernels import _lib
from repro_torch.kernels.dispatch import counted, kernel_device, require
from repro_torch.kernels.neoprof_update.ref import mark_hot_ref, update_ref


@counted("neoprof_update")
def sketch_update_kernel(counts, epochs, hot, page_ids, seeds, cur_epoch,
                         counter_max: int):
    """One block of ids into the sketch: -> (new_counts, new_epochs, est,
    hot_before), see :func:`.ref.update_ref` (meta inputs: meta outputs,
    no launch)."""
    kind = kernel_device(counts, epochs, hot, page_ids, seeds, cur_epoch)
    if kind == "cpu":
        return update_ref(counts, epochs, hot, page_ids, seeds, cur_epoch,
                          counter_max)
    d, w = counts.shape
    s = page_ids.shape[0]
    if kind == "meta":
        dev = counts.device
        return (torch.empty((d, w), dtype=torch.int32, device=dev),
                torch.empty((d, w), dtype=torch.uint8, device=dev),
                torch.empty((d, s), dtype=torch.int32, device=dev),
                torch.empty((d, s), dtype=torch.int32, device=dev))
    require(counts, "counts", torch.int32)
    require(epochs, "epochs", torch.uint8, (d, w))
    require(hot, "hot", torch.bool, (d, w))
    require(page_ids, "page_ids", torch.int32, (s,))
    require(seeds, "seeds", torch.int32, (d, PAGE_ID_BITS))
    require(cur_epoch, "cur_epoch", torch.uint8, ())
    dev = counts.device
    new_counts = torch.empty((d, w), dtype=torch.int32, device=dev)
    new_epochs = torch.empty((d, w), dtype=torch.uint8, device=dev)
    est = torch.empty((d, s), dtype=torch.int32, device=dev)
    hot_before = torch.empty((d, s), dtype=torch.int32, device=dev)
    err = _lib.lib().neoprof_update_launch(
        counts.data_ptr(), epochs.data_ptr(), hot.data_ptr(), page_ids.data_ptr(),
        seeds.data_ptr(), cur_epoch.data_ptr(), new_counts.data_ptr(),
        new_epochs.data_ptr(), est.data_ptr(), hot_before.data_ptr(),
        d, w, s, int(counter_max), _lib.stream_ptr(dev))
    _lib.check(err, "neoprof_update")
    sketch_update_kernel.launches += 1
    return new_counts, new_epochs, est, hot_before


sketch_update_kernel.launches = 0


@counted("neoprof_mark")
def sketch_mark_hot_kernel(hot, page_ids, is_hot, seeds):
    """Set the hot bits of every valid id flagged hot: -> new hot (D, W)
    bool (meta inputs: a meta output, no launch)."""
    kind = kernel_device(hot, page_ids, is_hot, seeds)
    if kind == "cpu":
        return mark_hot_ref(hot, page_ids, is_hot, seeds)
    d, w = hot.shape
    s = page_ids.shape[0]
    if kind == "meta":
        return torch.empty((d, w), dtype=torch.bool, device=hot.device)
    require(hot, "hot", torch.bool)
    require(page_ids, "page_ids", torch.int32, (s,))
    require(is_hot, "is_hot", torch.bool, (s,))
    require(seeds, "seeds", torch.int32, (d, PAGE_ID_BITS))
    out = torch.empty((d, w), dtype=torch.bool, device=hot.device)
    err = _lib.lib().neoprof_mark_launch(
        hot.data_ptr(), page_ids.data_ptr(), is_hot.data_ptr(), seeds.data_ptr(),
        out.data_ptr(), d, w, s, _lib.stream_ptr(hot.device))
    _lib.check(err, "neoprof_mark")
    sketch_mark_hot_kernel.launches += 1
    return out


sketch_mark_hot_kernel.launches = 0


def sketch_update(state: SketchState, page_ids: torch.Tensor,
                  theta: torch.Tensor, params: SketchParams,
                  ) -> tuple[SketchState, torch.Tensor]:
    """Same signature and semantics as ``core.sketch.sketch_update``."""
    page_ids = page_ids.to(torch.int32).contiguous()
    valid = page_ids >= 0
    new_counts, new_epochs, est, hot_before = sketch_update_kernel(
        state.counts, state.epochs, state.hot, page_ids, state.seeds,
        state.cur_epoch, params.counter_max)
    est_min = est.min(dim=0).values
    already_hot = (hot_before > 0).all(dim=0)
    is_hot = valid & (est_min > theta)
    newly_hot = is_hot & ~already_hot & _first_occurrence(
        torch.where(valid, page_ids, 0), valid)
    new_hot = sketch_mark_hot_kernel(state.hot, page_ids, is_hot, state.seeds)
    new_state = state._replace(
        counts=new_counts, epochs=new_epochs, hot=new_hot,
        n_seen=state.n_seen + valid.sum(dtype=torch.int32),
    )
    return new_state, newly_hot
