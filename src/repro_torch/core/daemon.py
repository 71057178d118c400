"""Legacy single-resource NeoMem daemon — a deprecation shim.

Port of ``repro/core/daemon.py``.  The orchestration loop lives in
:mod:`repro_torch.tiering` (a multiplexed daemon driving N resources on one
cadence with a shared quota budget).  This module keeps the original
``NeoMemDaemon(prof_params, tier_params)`` construction and explicit
``tick(prof, tier)`` threading as a thin wrapper over
:class:`repro_torch.tiering.TieredMemory`, so that callers of the old
surface keep working; new code should register a
:class:`repro_torch.tiering.TieredResource` with the multiplexed
:class:`repro_torch.tiering.NeoMemDaemon` instead.  The daemon runs on
``device`` (default the card), where the caller's ``prof`` and ``tier``
live.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.neoprof import NeoProfParams, NeoProfState
from repro_torch.core.policy import PolicyParams
from repro_torch.core.tiering import TierParams, TierState


@dataclasses.dataclass
class DaemonParams:
    """Legacy cadence params (quota defaults to 256, as before)."""

    migration_interval: int = 1        # ticks between promotion batches
    threshold_update_period: int = 8   # ticks between Algorithm-1 runs
    clear_interval: int = 64           # ticks between sketch resets
    quota_pages: int = 256             # per migration interval (m_quota)


class NeoMemDaemon:
    """Host-side daemon driving device-resident NeoProf + TieredStore."""

    def __init__(
        self,
        prof_params: NeoProfParams,
        tier_params: TierParams,
        daemon_params: DaemonParams | None = None,
        policy_params: PolicyParams | None = None,
        *,
        device="cuda",
    ):
        # Imported lazily: repro_torch.core's package init imports this
        # module, while repro_torch.tiering.memory imports repro_torch.core
        # submodules.
        from repro_torch.core.adapters.base import warn_deprecated
        from repro_torch.tiering.memory import DaemonParams as _DaemonParams
        from repro_torch.tiering.memory import TieredMemory
        from repro_torch.tiering.stats import TierStats

        warn_deprecated("core.daemon.NeoMemDaemon",
                        "TieredResource (or drive TieredMemory directly)")

        self.pp = prof_params
        self.tp = tier_params
        self.dp = daemon_params or DaemonParams()
        self.mem = TieredMemory(
            prof_params, tier_params,
            daemon_params=_DaemonParams(
                migration_interval=self.dp.migration_interval,
                threshold_update_period=self.dp.threshold_update_period,
                clear_interval=self.dp.clear_interval,
                quota_pages=self.dp.quota_pages),
            policy_params=policy_params, device=device)
        self.pol_params = self.mem.pol_params
        self.cmd = self.mem.cmd
        self.stats = TierStats(name="legacy")
        # p + tick carried across ticks (prof/tier are threaded by the caller)
        self._mstate = self.mem.init()

    def tick(
        self, prof: NeoProfState, tier: TierState
    ) -> tuple[NeoProfState, TierState]:
        """One daemon tick: run whatever cadences are due."""
        st = self._mstate._replace(prof=prof, tier=tier)
        st, _ = self.mem.tick(st, self.stats)
        self._mstate = st
        return st.prof, st.tier
