"""NeoMem dynamic hotness-threshold policy — a faithful port of Algorithm 1.

Line-by-line mapping to the paper (§V-A):

  line 4   F  <- get_neoprof_hist()          -> hist (64 bins)
  line 5   B  <- get_bandwidth_util()        -> bandwidth_util
  line 6   P  <- get_ping_pong_count()       -> ping_pong ratio (tiering stats)
  line 7   E  <- get_error_bound(F)          -> sketch error bound
  line 8   M  <- get_migrate_pages_count()   -> pages migrated last period
  line 9-12  p <- clip(p * (1+B)^a / (1+P)^b)   if M < m_quota
  line 13    p <- max(p_min, p/2)               else   (quota constraint)
  line 14-15 p <- max(p_min, p/2)               if Q_F(1-p) < E (error bound)
  line 16  theta = Q_F(1-p)

The policy lives in "user space" (host-side, plain floats) exactly as the
paper's policy does — only the inputs come from device-side NeoProf reads.
A copy of ``repro/core/policy.py`` (already host-side numpy).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import sketch as sk
from repro_torch.core.sketch import SketchParams


@dataclasses.dataclass
class PolicyParams:
    """Defaults = paper Table IV."""

    m_quota_pages: int = 4096          # migration quota per period (pages)
    p_min: float = 0.0001              # 0.01%
    p_max: float = 0.0156              # 1.56%
    p_init: float = 0.001              # 0.1%
    alpha: float = 1.0
    beta: float = 2.0
    theta_min: int = 1                 # never call a never-touched page hot


@dataclasses.dataclass
class PolicyState:
    p: float
    theta: int = 1
    # Telemetry for EXPERIMENTS / Fig. 14-style traces.
    last_B: float = 0.0
    last_P: float = 0.0
    last_E: int = 0

    @staticmethod
    def init(params: PolicyParams) -> "PolicyState":
        return PolicyState(p=params.p_init, theta=params.theta_min)


def quantile_from_hist_np(hist: np.ndarray, q: float) -> int:
    """Host-side Q_F over the 64-bin counter histogram."""
    edges = sk.hist_edges()
    total = max(int(hist.sum()), 1)
    cum = np.cumsum(hist)
    bin_id = int(np.searchsorted(cum, q * total))
    bin_id = min(bin_id, len(hist) - 1)
    return int(edges[min(bin_id + 1, len(edges) - 1)])


def error_bound_np(hist: np.ndarray, sparams: SketchParams, delta: float = 0.25) -> int:
    edges = sk.hist_edges(sparams.counter_bits)
    rank = sparams.width * (delta ** (1.0 / sparams.depth))
    cum_from_top = np.cumsum(hist[::-1])[::-1]
    idx = np.nonzero(cum_from_top >= rank)[0]
    if len(idx) == 0:
        return 0
    return int(edges[min(int(idx[-1]) + 1, len(edges) - 1)])


def update_threshold(
    state: PolicyState,
    params: PolicyParams,
    hist: np.ndarray,
    bandwidth_util: float,
    ping_pong_ratio: float,
    migrated_pages: int,
    error_bound: int,
) -> PolicyState:
    """One pass of Algorithm 1's while-loop body."""
    p = state.p
    if migrated_pages < params.m_quota_pages:                    # line 9
        p = p * (1.0 + bandwidth_util) ** params.alpha \
            / (1.0 + ping_pong_ratio) ** params.beta             # line 10
        p = float(np.clip(p, params.p_min, params.p_max))        # line 11
    else:
        p = max(params.p_min, p / 2.0)                           # line 13

    if quantile_from_hist_np(hist, 1.0 - p) < error_bound:       # line 14
        p = max(params.p_min, p / 2.0)                           # line 15

    theta = max(params.theta_min, quantile_from_hist_np(hist, 1.0 - p))  # line 16
    return PolicyState(
        p=p, theta=theta,
        last_B=float(bandwidth_util), last_P=float(ping_pong_ratio),
        last_E=int(error_bound),
    )


@dataclasses.dataclass
class StaticPolicy:
    """Fixed-threshold baseline (paper Fig. 14 comparison)."""

    theta: int

    def update(self, *_args, **_kw) -> "StaticPolicy":
        return self
