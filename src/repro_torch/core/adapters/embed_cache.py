"""Embedding-row tiering shim — NeoMem applied to vocab tables (§3.3).

Port of ``repro/core/adapters/embed_cache.py``, a deprecation shim over
:class:`repro_torch.tiering.EmbedRowsResource`: the access stream is the
token-id stream (the model's own input); pages are row-blocks of
``rows_per_page`` vocabulary rows.  New code should register an
``"embeddings"`` resource on a shared daemon instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tiering as tm
from repro_torch.core.adapters.base import LegacyTierAdapter, warn_deprecated

ROWS_PER_PAGE = tm.EMBED_ROWS_PER_PAGE


@dataclasses.dataclass
class EmbedTierConfig:
    vocab: int
    hot_slots: int
    rows_per_page: int = ROWS_PER_PAGE
    quota_pages: int = 64
    sketch_width: int = 1 << 14


class EmbedCache(LegacyTierAdapter):
    def __init__(self, cfg: EmbedTierConfig, migrate_fn=None, *, device="cuda"):
        warn_deprecated("core.adapters.EmbedCache",
                        '"embeddings" TieredResource')
        self.cfg = cfg
        n_pages = (cfg.vocab + cfg.rows_per_page - 1) // cfg.rows_per_page
        spec = tm.ResourceSpec(
            name="embeddings", n_pages=n_pages, hot_slots=cfg.hot_slots,
            quota_pages=cfg.quota_pages, sketch_width=cfg.sketch_width)
        super().__init__(tm.EmbedRowsResource(
            spec, rows_per_page=cfg.rows_per_page, migrate_fn=migrate_fn),
            device=device)

    def observe_tokens(self, tokens) -> None:
        """tokens: any-shape token ids (a tensor or an array)."""
        self._h.observe(torch.as_tensor(tokens, device=self._h.mem.device))
