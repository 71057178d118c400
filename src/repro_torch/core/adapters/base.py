"""Shared base for the legacy adapter shims (KVTier / ExpertCache / EmbedCache).

Port of ``repro/core/adapters/base.py``.  Each legacy adapter is a thin view
over ONE resource registered on a :class:`repro_torch.tiering.NeoMemDaemon`:
the stream encoding lives in :mod:`repro_torch.tiering.resources`, the state
is the :class:`TieredMemoryState`, and all hit-rate / policy arithmetic goes
through the unified :class:`repro_torch.tiering.TierStats` path.  The
``.prof`` / ``.tier`` / ``.daemon`` attributes of the old surface are kept
as properties.

The shim seeds its sketch as the reference's does, with
``jax.random.randint(PRNGKey(0), (D, 30), 0, W)``
(:func:`repro_torch.core.sketch.key_seeds`), so a shim fed the same stream
keeps the same placement.  It runs on ``device`` (default the card).
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch import tiering as tm
from repro_torch.core.sketch import key_seeds
from repro_torch.tiering.stats import LegacyDaemonStateView


def warn_deprecated(old: str, new: str) -> None:
    """One-liner the shims emit at construction (README: migration path)."""
    warnings.warn(
        f"{old} is a deprecation shim; register a {new} on the multiplexed "
        f"repro_torch.tiering.NeoMemDaemon instead (see README.md 'Migrating "
        f"off the legacy adapters' and DESIGN.md §1).",
        DeprecationWarning, stacklevel=3)


class _DaemonView:
    """Legacy per-adapter ``daemon`` attribute (cmd / policy / state / tp)."""

    def __init__(self, handle: tm.ResourceHandle):
        self._h = handle
        self.cmd = handle.mem.cmd

    tp = property(lambda self: self._h.mem.tp)
    pp = property(lambda self: self._h.mem.pp)
    dp = property(lambda self: self._h.mem.dp)
    pol_params = property(lambda self: self._h.mem.pol_params)

    @property
    def policy(self):
        return self._h.mem.policy_state(self._h.state, self._h.stats)

    @property
    def state(self) -> LegacyDaemonStateView:
        return LegacyDaemonStateView(self._h.stats)


class LegacyTierAdapter:
    """prof/tier threading + daemon facade shared by the three shims."""

    def __init__(self, resource, daemon_params: tm.DaemonParams | None = None,
                 *, device="cuda"):
        spec = resource.spec
        self._daemon = tm.NeoMemDaemon(daemon_params or tm.DaemonParams(),
                                       device=device)
        self._h = self._daemon.register(
            resource, seeds=key_seeds(spec.sketch_depth, spec.sketch_width))
        self.daemon = _DaemonView(self._h)

    @property
    def spec(self) -> tm.ResourceSpec:
        return self._h.resource.spec

    @property
    def handle(self) -> tm.ResourceHandle:
        return self._h

    # legacy mutable-attribute surface -------------------------------------
    @property
    def prof(self):
        return self._h.state.prof

    @prof.setter
    def prof(self, value):
        self._h.state = self._h.state._replace(prof=value)

    @property
    def tier(self):
        return self._h.state.tier

    @tier.setter
    def tier(self, value):
        self._h.state = self._h.state._replace(tier=value)

    def tick(self) -> None:
        self._daemon.tick()

    def hit_rate(self) -> float:
        return self._h.hit_rate()

    # migration data plane — forwarded to the unified layer (DESIGN.md §8)
    def bind_data(self, slow_data) -> None:
        """Attach payload (a tensor); promotions then move real bytes
        (metered)."""
        self._h.bind_data(slow_data)

    def read_rows(self, page_ids):
        """Serve payload rows: fast-buffer hit, slow-tier fallback."""
        return self._h.read_rows(page_ids)

    @property
    def migration_bytes(self) -> int:
        return self._h.stats.migration_bytes

    def residency(self) -> np.ndarray:
        """page -> fast-slot (-1 if slow-tier / host-resident)."""
        return self.tier.page_slot.cpu().numpy()
