"""The port's profiler and policy loop against the reference, on the CPU:
NeoProf observe, Algorithm 1, 2Q placement and the multiplexed daemon with
one "kv" resource fed the same (mass, ids) streams.  The port starts from
the reference's H3 seeds; all integer state must match bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.dist.host_offload as ho  # noqa: E402
from repro.core import neoprof as jnp_prof  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.core import tiering as j_tier  # noqa: E402
from repro import tiering as j_tm  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.core import neoprof as t_prof  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.core import tiering as t_tier  # noqa: E402
from repro_torch.tiering import daemon as t_daemon  # noqa: E402
from repro_torch.tiering import memory as t_memory  # noqa: E402
from repro_torch.tiering import resource as t_resource  # noqa: E402
from repro_torch.tiering import resources as t_resources  # noqa: E402


@pytest.fixture
def device_tier_probe(monkeypatch):
    """Keep the reference's slow tier a device array on the CPU backend
    (ROADMAP C0): jax 0.9 reports a pinned_host kind there, and the
    reference's dual-tier gather then fails."""
    monkeypatch.setitem(ho._probe_cache, "kinds", ("device",))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(np.asarray(port.cpu()), np.asarray(ref),
                                  err_msg=msg)


def _eq_tuple(port, ref, prefix):
    for name, p, r in zip(type(ref)._fields, port, ref):
        if hasattr(r, "_fields"):
            _eq_tuple(p, r, f"{prefix}.{name}")
        else:
            _eq(p, r, f"{prefix}.{name}")


def test_neoprof_observe_matches_reference():
    """Sketch, hot buffer (with overflow drops) and monitor, block by block."""
    jp = jnp_prof.NeoProfParams(sketch=jsk.SketchParams(width=1 << 10),
                                hot_buffer_entries=16)
    tp = t_prof.NeoProfParams(sketch=tsk.SketchParams(width=1 << 10),
                              hot_buffer_entries=16)
    js = jnp_prof.neoprof_init(jp)
    ts = t_prof.neoprof_init(tp, sketch_seeds_from_jax(js.sketch.seeds),
                             device="cpu")
    cmd_j, cmd_t = jnp_prof.NeoProfCommands(jp), t_prof.NeoProfCommands(tp)
    rng = np.random.default_rng(0)
    for block in range(6):
        ids = rng.integers(-1, 40, 64).astype(np.int32)
        js = jnp_prof.neoprof_observe(js, jnp.asarray(ids), jp, rd_bytes=3.0,
                                      wr_bytes=1.5, budget_bytes=10.0)
        ts = t_prof.neoprof_observe(ts, torch.from_numpy(ids), tp, rd_bytes=3.0,
                                    wr_bytes=1.5, budget_bytes=10.0)
        _eq_tuple(ts, js, f"block{block}")
        if block == 2:
            js, got_j = cmd_j.drain_hotpages(js)
            ts, got_t = cmd_t.drain_hotpages(ts)
            np.testing.assert_array_equal(got_t, got_j)
        if block == 4:
            js, ts = cmd_j.reset(js), cmd_t.reset(ts)
    assert int(ts.dropped) > 0          # the buffer overflowed at least once
    np.testing.assert_array_equal(cmd_t.get_hist(ts), cmd_j.get_hist(js))
    assert cmd_t.get_error_bound(ts) == cmd_j.get_error_bound(js)
    assert cmd_t.bandwidth_util(ts) == cmd_j.bandwidth_util(js)


def test_update_threshold_matches_reference():
    rng = np.random.default_rng(1)
    jp, tp = j_policy.PolicyParams(), t_policy.PolicyParams()
    js, ts = j_policy.PolicyState.init(jp), t_policy.PolicyState.init(tp)
    for _ in range(20):
        hist = rng.integers(0, 400, 64)
        kw = dict(bandwidth_util=float(rng.random()),
                  ping_pong_ratio=float(rng.random() * 0.3),
                  migrated_pages=int(rng.integers(0, 8000)),
                  error_bound=int(rng.integers(0, 8)))
        js = j_policy.update_threshold(js, jp, hist, **kw)
        ts = t_policy.update_threshold(ts, tp, hist, **kw)
        assert (ts.p, ts.theta, ts.last_E) == (js.p, js.theta, js.last_E)


def test_touch_promote_drain_match_reference():
    """A random run of touches, promotions and drains: every TierState field
    equal after every verb, the returned batches too."""
    params = j_tier.TierParams(num_pages=40, num_slots=6, quota_pages=5)
    js = j_tier.tier_init(params)
    ts = t_tier.tier_init(t_tier.TierParams(40, 6, 5), device="cpu")
    rng = np.random.default_rng(2)
    for it in range(30):
        touch = rng.integers(-1, 40, 12).astype(np.int32)
        js = j_tier.touch(js, jnp.asarray(touch))
        ts = t_tier.touch(ts, torch.from_numpy(touch))
        _eq_tuple(ts, js, f"touch{it}")
        if it % 2:
            hot = rng.integers(-1, 40, 5).astype(np.int32)
            hot[1] = hot[0]                                 # duplicate
            js, pj, vj = j_tier.promote(js, jnp.asarray(hot), 5)
            ts, pt, vt = t_tier.promote(ts, torch.from_numpy(hot), 5)
            _eq(pt, pj, "promoted")
            _eq(vt, vj, "victims")
            _eq_tuple(ts, js, f"promote{it}")
        if it % 7 == 6:
            js, dj = j_tier.drain_period_stats(js)
            ts, dt = t_tier.drain_period_stats(ts)
            assert {k: int(v) for k, v in dt.items()} == \
                {k: int(v) for k, v in dj.items()}
            _eq_tuple(ts, js, f"drain{it}")
    slots_j, hit_j = j_tier.lookup(js, jnp.arange(-1, 40))
    slots_t, hit_t = t_tier.lookup(ts, torch.arange(-1, 40))
    _eq(slots_t, slots_j)
    _eq(hit_t, hit_j)


def test_victim_ties_pick_lowest_slot_first():
    """``lax.top_k(-rank)`` takes equal ranks in slot order; the port's
    stable sort must pick the same slots."""
    params = j_tier.TierParams(num_pages=20, num_slots=8, quota_pages=3)
    js = j_tier.tier_init(params)
    ts = t_tier.tier_init(t_tier.TierParams(20, 8, 3), device="cpu")
    hot = np.array([5, 9, 2], np.int32)
    js, _, vj = j_tier.promote(js, jnp.asarray(hot), 3)   # all slots free: ties
    ts, _, vt = t_tier.promote(ts, torch.from_numpy(hot), 3)
    _eq(vt, vj)
    assert vt.tolist() == [0, 1, 2]
    # equal class and last_touch among the occupied slots: ties again
    js, _, vj = j_tier.promote(js, jnp.asarray(np.array([11, 12, 13], np.int32)), 3)
    ts, _, vt = t_tier.promote(ts, torch.tensor([11, 12, 13], dtype=torch.int32), 3)
    _eq(vt, vj)
    assert vt.tolist() == [3, 4, 5]


def _kv_specs(n_pages=32, slots=6, quota=4):
    kw = dict(n_pages=n_pages, hot_slots=slots, quota_pages=quota,
              sketch_width=1 << 10, row_shape=(2, 4, 1, 8), row_dtype="bfloat16")
    return j_tm.ResourceSpec("kv", **kw), t_resource.ResourceSpec("kv", **kw)


def test_daemon_kv_loop_matches_reference(device_tier_probe):
    """One "kv" resource on each daemon, fed the same recorded (mass, ids)
    stream with owner writes between ticks: sketch, hot buffer, θ trace,
    placement maps, payload buffers and every integer TierStats field."""
    spec_j, spec_t = _kv_specs()
    dp = dict(migration_interval=1, threshold_update_period=4, clear_interval=12)
    dj = j_tm.NeoMemDaemon(j_tm.DaemonParams(**dp))
    hj = dj.register(j_tm.KVPagesResource(spec_j, mass_threshold=0.1))
    dt = t_daemon.NeoMemDaemon(t_memory.DaemonParams(**dp), device="cpu")
    ht = dt.register(t_resources.KVPagesResource(spec_t, mass_threshold=0.1),
                     seeds=sketch_seeds_from_jax(hj.state.prof.sketch.seeds))
    rng = np.random.default_rng(4)
    payload = rng.standard_normal((32,) + spec_j.row_shape).astype(ml_dtypes.bfloat16)
    hj.bind_data(jnp.asarray(payload))
    ht.bind_data(params_from_jax(payload, device="cpu"))
    hot_pages = np.array([3, 7, 8, 20])
    for step in range(40):
        ids = np.where(rng.random(6) < 0.85,
                       rng.choice(np.r_[hot_pages, rng.integers(0, 32, 4)], 6), -1)
        mass = rng.dirichlet(np.ones(6) * 0.5).astype(np.float32)
        dj.observe("kv", jnp.asarray(mass), jnp.asarray(ids, jnp.int32))
        dt.observe("kv", torch.from_numpy(mass), torch.from_numpy(ids.astype(np.int32)))
        if step % 5 == 0:      # owner flush of two pages
            wid = rng.integers(0, 32, 2).astype(np.int32)
            rows = rng.standard_normal((2,) + spec_j.row_shape).astype(ml_dtypes.bfloat16)
            hj.write_rows(jnp.asarray(wid), jnp.asarray(rows))
            ht.write_rows(torch.from_numpy(wid), params_from_jax(rows, device="cpu"))
        dj.tick()
        dt.tick()
        _eq_tuple(ht.state.prof, hj.state.prof, f"prof{step}")
        _eq(ht.state.tier.page_slot, hj.state.tier.page_slot, f"page_slot{step}")
        _eq(ht.state.tier.slot_page, hj.state.tier.slot_page, f"slot_page{step}")
    sj, st = hj.stats, ht.stats
    assert st.theta_trace == sj.theta_trace
    assert st.err_trace == sj.err_trace
    assert st.p_trace == sj.p_trace
    int_fields = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
                  "migrated_this_period", "pending", "migration_bytes",
                  "last_epoch_bytes", "max_epoch_bytes", "quota_bytes",
                  "migration_epochs", "flush_bytes")
    assert {f: getattr(st, f) for f in int_fields} == \
        {f: getattr(sj, f) for f in int_fields}
    assert st.migration_bytes > 0 and st.promoted > 0
    rows_j = np.asarray(hj.mem.buffers.fast).view(np.uint16)
    rows_t = ht.mem.buffers.fast.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(rows_t, rows_j)
    ids = np.arange(32, dtype=np.int32)
    np.testing.assert_array_equal(
        ht.read_rows(torch.from_numpy(ids)).view(torch.int16).numpy().view(np.uint16),
        np.asarray(hj.read_rows(jnp.asarray(ids))).view(np.uint16))
    wall = ("stall_s", "overlap_bytes_per_decode_s")     # host clock readings
    row_t, row_j = dt.snapshot()["kv"], dj.snapshot()["kv"]
    assert {k: v for k, v in row_t.items() if k not in wall} == \
        {k: v for k, v in row_j.items() if k not in wall}


def test_daemon_hit_rates_match_reference(device_tier_probe):
    """``hit_rates()`` of a daemon holding a "kv" and an "embeddings"
    resource, both fed the same streams as the reference's: equal to the
    reference's after every tick, a Python float per resource, and equal to
    each ``snapshot()`` row's ``hit_rate`` (the undrained period counters
    folded in)."""
    spec_j, spec_t = _kv_specs()
    ekw = dict(n_pages=16, hot_slots=4, quota_pages=2, sketch_width=1 << 10)
    dp = dict(migration_interval=2, threshold_update_period=4, clear_interval=12)
    dj = j_tm.NeoMemDaemon(j_tm.DaemonParams(**dp))
    dt = t_daemon.NeoMemDaemon(t_memory.DaemonParams(**dp), device="cpu")
    for rj, rt in ((j_tm.KVPagesResource(spec_j, mass_threshold=0.1),
                    t_resources.KVPagesResource(spec_t, mass_threshold=0.1)),
                   (j_tm.EmbedRowsResource(j_tm.ResourceSpec("embeddings", **ekw),
                                           rows_per_page=8),
                    t_resources.EmbedRowsResource(
                        t_resource.ResourceSpec("embeddings", **ekw),
                        rows_per_page=8))):
        hj = dj.register(rj)
        dt.register(rt, seeds=sketch_seeds_from_jax(hj.state.prof.sketch.seeds))
    rng = np.random.default_rng(5)
    hot_pages = np.array([3, 7, 8, 20])
    for step in range(24):
        ids = np.where(rng.random(6) < 0.85,
                       rng.choice(np.r_[hot_pages, rng.integers(0, 32, 4)], 6),
                       -1).astype(np.int32)
        mass = rng.dirichlet(np.ones(6) * 0.5).astype(np.float32)
        tokens = np.minimum(rng.geometric(0.04, 10) - 1, 127).astype(np.int32)
        dj.observe("kv", jnp.asarray(mass), jnp.asarray(ids))
        dt.observe("kv", torch.from_numpy(mass), torch.from_numpy(ids))
        dj.observe("embeddings", jnp.asarray(tokens))
        dt.observe("embeddings", torch.from_numpy(tokens))
        dj.tick()
        dt.tick()
        got = dt.hit_rates()
        assert got == dj.hit_rates(), step
        assert all(type(v) is float for v in got.values())
        assert got == {n: row["hit_rate"] for n, row in dt.snapshot().items()}
    assert 0 < got["kv"] < 1 and 0 < got["embeddings"] < 1, got


@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.25])
def test_kv_encode_stream_matches_reference(threshold):
    """The kv page stream: resident ids whose mass share reaches the
    threshold, cold and empty pages as -1 (an all-zero mass row too)."""
    rng = np.random.default_rng(7)
    mass = rng.random((3, 16)).astype(np.float32) ** 4
    mass[1, ::3] = 0.0
    mass[2] = 0.0
    ids = np.where(rng.random(16) < 0.2, -1, rng.integers(0, 64, 16)).astype(np.int32)
    spec_j, spec_t = _kv_specs(n_pages=64)
    jr = j_tm.KVPagesResource(spec_j, mass_threshold=threshold)
    tr = t_resources.KVPagesResource(spec_t, mass_threshold=threshold)
    for row in mass:
        _eq(tr.encode_stream(torch.from_numpy(row), torch.from_numpy(ids)),
            jr.encode_stream(jnp.asarray(row), jnp.asarray(ids)))
