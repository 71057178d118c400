"""repro_torch.workloads — trace-driven multi-tenant workload generators.

A numpy-only copy of ``repro/workloads``: seeded, replayable arrival traces
(zipf-hot / diurnal-shift / scan-antagonist / prefill-heavy / agentic /
prod-mixture) for the continuous-batching scheduler, identical to the
reference's for every kind, arrival process and seed; see
:mod:`repro_torch.workloads.traces` and DESIGN.md §9 / §12 / §13.
"""
from repro_torch.workloads.traces import (  # noqa: F401
    ARRIVAL_KINDS, DEFAULT_TENANTS, PREFILL_HEAVY_TENANTS, TRACE_KINDS,
    Arrival, TenantProfile, Trace, make_trace, play,
)
