"""The port's copy of the trace generator against the reference's: the same
arrivals (steps, tenants, prompt tokens, max_new) for every trace kind and
arrival process, at two seeds and at the smoke and full vocabularies.
Exact equality: both draw from the same numpy streams."""
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import workloads as j_wl  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402


def test_kinds_and_tenants_match_reference():
    assert t_wl.TRACE_KINDS == j_wl.TRACE_KINDS
    assert t_wl.ARRIVAL_KINDS == j_wl.ARRIVAL_KINDS
    for name in ("DEFAULT_TENANTS", "PREFILL_HEAVY_TENANTS"):
        assert [vars(t) for t in getattr(t_wl, name)] == \
            [vars(t) for t in getattr(j_wl, name)]


@pytest.mark.parametrize("vocab", [256, 128256])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arrival", j_wl.ARRIVAL_KINDS)
@pytest.mark.parametrize("kind", j_wl.TRACE_KINDS)
def test_make_trace_matches_reference(kind, arrival, seed, vocab):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the MMPP saturation warning
        ref = j_wl.make_trace(kind, n_steps=120, vocab=vocab, seed=seed,
                              arrival=arrival)
        port = t_wl.make_trace(kind, n_steps=120, vocab=vocab, seed=seed,
                               arrival=arrival)
    assert (port.kind, port.seed, port.vocab, port.n_steps, port.arrival) == \
        (ref.kind, ref.seed, ref.vocab, ref.n_steps, ref.arrival)
    assert len(port.arrivals) == len(ref.arrivals) > 0
    for a, b in zip(port.arrivals, ref.arrivals):
        assert (a.step, a.tenant, a.max_new) == (b.step, b.tenant, b.max_new)
        assert a.tokens.dtype == b.tokens.dtype
        np.testing.assert_array_equal(a.tokens, b.tokens)
