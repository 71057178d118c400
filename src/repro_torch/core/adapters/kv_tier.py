"""Paged-KV tiering shim — NeoMem applied to long-context KV caches (§3.2).

Port of ``repro/core/adapters/kv_tier.py``, a deprecation shim: the stream
encoding lives in :class:`repro_torch.tiering.KVPagesResource` (pages ranked
by their share of the attention softmax mass, DESIGN.md §3.2) and the
orchestration in the multiplexed :class:`repro_torch.tiering.NeoMemDaemon`.
Only the construction path (config + DeprecationWarning + the base adapter
surface) survives.  New code should register a ``"kv"`` resource on a shared
daemon instead.
"""
from __future__ import annotations

import dataclasses

from repro_torch import tiering as tm
from repro_torch.core.adapters.base import LegacyTierAdapter, warn_deprecated


@dataclasses.dataclass
class KVTierConfig:
    n_pages_total: int           # full history pages (slow tier)
    hot_slots: int               # fast-tier page slots (per layer group)
    quota_pages: int = 64
    sketch_width: int = 1 << 14
    mass_threshold: float = 0.02  # page matters if it carries >=2% softmax mass


class KVTier(LegacyTierAdapter):
    def __init__(self, cfg: KVTierConfig, migrate_fn=None, *, device="cuda"):
        warn_deprecated("core.adapters.KVTier", '"kv" TieredResource')
        self.cfg = cfg
        spec = tm.ResourceSpec(
            name="kv", n_pages=cfg.n_pages_total, hot_slots=cfg.hot_slots,
            quota_pages=cfg.quota_pages, sketch_width=cfg.sketch_width,
            touch_cap=1 << 14)
        super().__init__(tm.KVPagesResource(
            spec, mass_threshold=cfg.mass_threshold, migrate_fn=migrate_fn),
            device=device)
        self.prof_params = spec.prof_params()
