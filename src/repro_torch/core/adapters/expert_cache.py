"""MoE expert tiering shim — NeoMem applied to expert weights (DESIGN.md §3.1).

Port of ``repro/core/adapters/expert_cache.py``, a deprecation shim over
:class:`repro_torch.tiering.ExpertStreamResource`: the access stream is the
router's token->expert assignments; a *page* is one expert's weight block
for one layer group (page_id = group * n_experts + expert).  One
:class:`~repro_torch.tiering.ResourceSpec` sources both the tier geometry
and the daemon quota.  New code should register an ``"experts"`` resource on
a shared multiplexed daemon instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tiering as tm
from repro_torch.core.adapters.base import LegacyTierAdapter, warn_deprecated


@dataclasses.dataclass
class ExpertTierConfig:
    n_groups: int
    n_experts: int
    hot_slots: int               # experts resident in HBM per layer group
    quota_pages: int = 32        # expert promotions per migration interval
    sketch_width: int = 1 << 14


class ExpertCache(LegacyTierAdapter):
    """Host-side manager wiring NeoProf <-> TieredStore for expert weights."""

    def __init__(self, cfg: ExpertTierConfig, migrate_fn=None, *, device="cuda"):
        warn_deprecated("core.adapters.ExpertCache", '"experts" TieredResource')
        self.cfg = cfg
        spec = tm.ResourceSpec(
            name="experts", n_pages=cfg.n_groups * cfg.n_experts,
            hot_slots=cfg.n_groups * cfg.hot_slots,
            quota_pages=cfg.quota_pages, sketch_width=cfg.sketch_width)
        super().__init__(tm.ExpertStreamResource(
            spec, n_experts=cfg.n_experts, migrate_fn=migrate_fn), device=device)

    def observe_step(self, router_streams) -> None:
        """router_streams: (G, n_moe, B, S, k) from the forward pass (a
        tensor or an array)."""
        self._h.observe(torch.as_tensor(router_streams, device=self._h.mem.device))
