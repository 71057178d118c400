"""Plain PyTorch versions of the sketch update and mark kernels.

They compute the same functions as ``csrc/neoprof_update.cu`` (and as the
reference's ``update_ref`` / ``mark_hot_ref``) with the state's at-rest
types: int32 counts, uint8 epoch tags, bool hot bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import h3_hash


def update_ref(counts, epochs, hot, page_ids, seeds, cur_epoch, counter_max):
    """-> (new_counts int32 (D,W), new_epochs uint8 (D,W), est int32 (D,S),
    hot_before int32 (D,S)); padding ids (< 0) read 0 in est/hot_before."""
    valid = page_ids >= 0
    idx = h3_hash(torch.where(valid, page_ids, 0), seeds).long()   # (D, S)
    live = torch.where(epochs == cur_epoch, counts, 0)
    new_counts = live.scatter_add(1, idx, valid.to(torch.int32).expand_as(idx))
    new_counts = new_counts.clamp_max(counter_max)
    new_epochs = cur_epoch.to(torch.uint8).expand_as(epochs).clone()
    est = torch.where(valid[None], new_counts.gather(1, idx), 0)
    hot_before = torch.where(valid[None], hot.gather(1, idx).to(torch.int32), 0)
    return new_counts, new_epochs, est, hot_before


def mark_hot_ref(hot, page_ids, is_hot, seeds):
    """Set the hot bit at the H3 positions of every valid id flagged hot."""
    mark = ((page_ids >= 0) & (is_hot > 0)).to(torch.int32)
    idx = h3_hash(torch.where(page_ids >= 0, page_ids, 0), seeds).long()
    return hot.to(torch.int32).scatter_reduce(
        1, idx, mark.expand_as(idx), reduce="amax").bool()
