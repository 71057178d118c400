"""NeoProf — the device-side profiler (paper §IV), in PyTorch.

Port of ``repro/core/neoprof.py``: Page Monitor (snoops the page-id streams
the model computes), NeoProf Core (CM-sketch hot page detector + hot-page
buffer + histogram unit) and State Monitor (bandwidth accounting), with the
host-facing command set of Table I in :class:`NeoProfCommands`.

The sketch update and the histogram go through the kernel wrappers
(:mod:`repro_torch.kernels.neoprof_update`, :mod:`repro_torch.kernels.cms_hist`):
on a CUDA tensor they launch the Hopper kernels, on a CPU tensor they run
the plain versions.  The state's device decides; there is no switch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.scatter import scatter_drop
from repro_torch.core.sketch import SketchParams, SketchState
from repro_torch.kernels.cms_hist import ops as hist_ops
from repro_torch.kernels.neoprof_update import ops as update_ops


class NeoProfParams(NamedTuple):
    sketch: SketchParams = SketchParams()
    hot_buffer_entries: int = 1 << 12   # paper: 16K
    delta: float = 0.25                 # error-bound confidence (paper ex.)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class StateMonitor(NamedTuple):
    """Read/Write/bandwidth accounting (paper GetNrSample/GetRdCnt/GetWrCnt)."""

    rd_bytes: torch.Tensor   # () float32 — slow-tier bytes read this period
    wr_bytes: torch.Tensor   # () float32 — slow-tier bytes written this period
    total_budget: torch.Tensor  # () float32 — bytes the tier could have moved

    @staticmethod
    def init(device="cuda") -> "StateMonitor":
        return StateMonitor(_f32(0.0, device), _f32(0.0, device),
                            _f32(1.0, device))


class NeoProfState(NamedTuple):
    sketch: SketchState
    monitor: StateMonitor
    hot_buf: torch.Tensor    # (hot_buffer_entries,) int32 page ids, -1 = empty
    hot_count: torch.Tensor  # () int32 valid entries in hot_buf
    dropped: torch.Tensor    # () int32 hot pages dropped on buffer overflow
    theta: torch.Tensor      # () int32 current hotness threshold


def neoprof_init(params: NeoProfParams, seeds: torch.Tensor | None = None, *,
                 device="cuda") -> NeoProfState:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return NeoProfState(
        sketch=sk.sketch_init(params.sketch, seeds, device=device),
        monitor=StateMonitor.init(device),
        hot_buf=torch.full((params.hot_buffer_entries,), -1, dtype=torch.int32,
                           device=device),
        hot_count=z, dropped=z.clone(),
        theta=torch.ones((), dtype=torch.int32, device=device),
    )


def _append_hot(hot_buf: torch.Tensor, hot_count: torch.Tensor,
                dropped: torch.Tensor, page_ids: torch.Tensor,
                mask: torch.Tensor):
    """Compact masked page ids into the fixed-capacity hot buffer."""
    cap = hot_buf.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1 + hot_count
    ok = mask & (pos < cap)
    # overflow / non-hot lanes write the trash row and are dropped
    hot_buf = scatter_drop(hot_buf, torch.where(ok, pos, cap), page_ids)
    n_new = ok.sum(dtype=torch.int32)
    n_drop = (mask & ~ok).sum(dtype=torch.int32)
    return hot_buf, hot_count + n_new, dropped + n_drop


def neoprof_observe(state: NeoProfState, page_ids: torch.Tensor,
                    params: NeoProfParams, rd_bytes=0.0, wr_bytes=0.0,
                    budget_bytes=0.0) -> NeoProfState:
    """Feed one block of the access stream (negative ids = padding): sketch
    update, hot detection and filtering, buffer append, State Monitor."""
    page_ids = page_ids.to(torch.int32)
    new_sketch, newly_hot = update_ops.sketch_update(
        state.sketch, page_ids, state.theta, params.sketch)
    hot_buf, hot_count, dropped = _append_hot(
        state.hot_buf, state.hot_count, state.dropped,
        torch.where(page_ids >= 0, page_ids, 0), newly_hot)
    mon, dev = state.monitor, page_ids.device
    mon = StateMonitor(
        rd_bytes=mon.rd_bytes + _f32(rd_bytes, dev),
        wr_bytes=mon.wr_bytes + _f32(wr_bytes, dev),
        total_budget=mon.total_budget + _f32(budget_bytes, dev),
    )
    return state._replace(sketch=new_sketch, monitor=mon, hot_buf=hot_buf,
                          hot_count=hot_count, dropped=dropped)


class NeoProfCommands:
    """The MMIO command set of paper Table I, as a host-side façade."""

    def __init__(self, params: NeoProfParams):
        self.params = params

    # -- control -----------------------------------------------------------
    def reset(self, state: NeoProfState) -> NeoProfState:          # 0x100
        dev = state.hot_buf.device
        return state._replace(
            sketch=sk.sketch_clear(state.sketch),
            monitor=StateMonitor.init(dev),
            hot_buf=torch.full_like(state.hot_buf, -1),
            hot_count=torch.zeros((), dtype=torch.int32, device=dev),
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def set_threshold(self, state: NeoProfState, theta) -> NeoProfState:  # 0x200
        return state._replace(theta=torch.as_tensor(
            theta, dtype=torch.int32, device=state.theta.device))

    # -- hot pages ----------------------------------------------------------
    def get_nr_hotpage(self, state: NeoProfState) -> int:          # 0x300
        return int(state.hot_count)

    def get_hotpages(self, state: NeoProfState) -> np.ndarray:     # 0x400 (seq.)
        n = int(state.hot_count)
        return state.hot_buf[:n].cpu().numpy()

    def drain_hotpages(self, state: NeoProfState
                       ) -> tuple[NeoProfState, np.ndarray]:
        pages = self.get_hotpages(state)
        return state._replace(
            hot_buf=torch.full_like(state.hot_buf, -1),
            hot_count=torch.zeros_like(state.hot_count),
        ), pages

    # -- state monitor ------------------------------------------------------
    def get_nr_sample(self, state: NeoProfState) -> float:         # 0x500
        return float(state.monitor.total_budget)

    def get_rd_cnt(self, state: NeoProfState) -> float:            # 0x600
        return float(state.monitor.rd_bytes)

    def get_wr_cnt(self, state: NeoProfState) -> float:            # 0x700
        return float(state.monitor.wr_bytes)

    def bandwidth_util(self, state: NeoProfState) -> float:
        m = state.monitor
        return float((m.rd_bytes + m.wr_bytes)
                     / torch.clamp_min(m.total_budget, 1.0))

    # -- histogram unit ------------------------------------------------------
    def get_hist(self, state: NeoProfState) -> np.ndarray:         # 0x800-0xA00
        return hist_ops.sketch_histogram(state.sketch,
                                         self.params.sketch).cpu().numpy()

    def get_error_bound(self, state: NeoProfState, hist=None) -> int:
        h = self.get_hist(state) if hist is None else hist
        return sk.error_bound_from_hist(h, self.params.sketch, self.params.delta)
