"""Plain PyTorch version of the histogram kernel (``csrc/cms_hist.cu``)."""
from __future__ import annotations

import torch

from repro_torch.core.sketch import HIST_BINS


def hist_ref(counts_row0, epochs_row0, cur_epoch, edges):
    """64-bin histogram of the live counters of one sketch row: a stale tag
    reads 0; bin k holds values in [edges[k], edges[k+1])."""
    live = torch.where(epochs_row0 == cur_epoch, counts_row0, 0)
    bin_idx = (torch.searchsorted(edges, live, right=True) - 1).clamp(0, HIST_BINS - 1)
    hist = torch.zeros((HIST_BINS,), dtype=torch.int32, device=live.device)
    return hist.index_add_(0, bin_idx, torch.ones_like(live))
