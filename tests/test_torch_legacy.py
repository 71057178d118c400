"""The legacy tiering shims (``core/daemon.py``, ``core/adapters/*``) and the
tiering surface they ride on (``ResourceHandle.observe_pages``, the
resources' ``migrate_fn`` hook) against the reference, on the CPU.

The same seeded numpy streams go through both packages; the port's sketches
take the reference's H3 seeds (the shims do so themselves, through
``core.sketch.key_seeds``).  Every comparison is bitwise: placement tables,
the ``TierStats`` counters and the θ trace, and each promotion batch.  The
reference's data plane needs the C0 probe pin (ROADMAP C0).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as j_core  # noqa: E402
import repro.tiering as j_tm  # noqa: E402
from repro.core import daemon as j_daemon  # noqa: E402
from repro.core.adapters import embed_cache as j_embed  # noqa: E402
from repro.core.adapters import expert_cache as j_expert  # noqa: E402
from repro.core.adapters import kv_tier as j_kv  # noqa: E402
from repro.dist import host_offload as j_ho  # noqa: E402

import repro_torch.core as t_core  # noqa: E402
import repro_torch.tiering as t_tm  # noqa: E402
from repro_torch.core import daemon as t_daemon  # noqa: E402
from repro_torch.core.adapters import embed_cache as t_embed  # noqa: E402
from repro_torch.core.adapters import expert_cache as t_expert  # noqa: E402
from repro_torch.core.adapters import kv_tier as t_kv  # noqa: E402
from repro_torch.core.sketch import key_seeds  # noqa: E402

COUNTERS = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
            "migrated_this_period")


@pytest.fixture(autouse=True)
def quiet_shims():
    """The shims warn at every construction; the tests that hold the
    warning catch it themselves."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def hold(port_tier, ref_tier, port_stats, ref_stats, what: str) -> None:
    """Placement tables, drained counters and θ trace bitwise."""
    for field in ("page_slot", "slot_page"):
        np.testing.assert_array_equal(getattr(port_tier, field).numpy(),
                                      np.asarray(getattr(ref_tier, field)),
                                      err_msg=f"{what}: {field}")
    assert {k: getattr(port_stats, k) for k in COUNTERS} == {
        k: getattr(ref_stats, k) for k in COUNTERS}, what
    assert port_stats.theta_trace == [int(t) for t in ref_stats.theta_trace], what


def daemon_stream(step_rng):
    hot = step_rng.integers(900, 916, 192)       # 16 hot pages
    cold = step_rng.integers(0, 900, 64)
    return np.concatenate([hot, cold]).astype(np.int32)


def test_legacy_daemon_promotes_hot_pages_as_reference():
    """P5: ``repro_torch.core.NeoMemDaemon`` is the legacy single-resource
    daemon; threaded through ``tick(prof, tier)`` it places, counts and
    retunes θ as the reference's (``test_daemon_promotes_hot_pages``)."""
    assert t_core.NeoMemDaemon is t_daemon.NeoMemDaemon
    assert t_core.DaemonParams is t_daemon.DaemonParams
    assert t_core.DaemonParams().quota_pages == j_core.DaemonParams().quota_pages == 256
    dp = dict(migration_interval=1, threshold_update_period=4, clear_interval=16)
    jpp = j_core.NeoProfParams(sketch=j_core.SketchParams(width=1 << 12))
    jtp = j_core.TierParams(num_pages=1024, num_slots=64, quota_pages=32)
    tpp = t_core.NeoProfParams(sketch=t_core.SketchParams(width=1 << 12))
    ttp = t_core.TierParams(num_pages=1024, num_slots=64, quota_pages=32)
    jd = j_core.NeoMemDaemon(jpp, jtp, j_core.DaemonParams(**dp))
    td = t_core.NeoMemDaemon(tpp, ttp, t_core.DaemonParams(**dp), device="cpu")
    assert vars(td.pol_params) == vars(jd.pol_params) and td.mem.quota == jd.mem.quota == 256
    jprof, jtier = j_core.neoprof_init(jpp), j_core.tier_init(jtp)
    tprof = t_core.neoprof_init(tpp, key_seeds(2, 1 << 12), device="cpu")
    ttier = t_core.tier_init(ttp, device="cpu")
    jprof, tprof = jd.cmd.set_threshold(jprof, 8), td.cmd.set_threshold(tprof, 8)
    rng = np.random.default_rng(0)
    for step in range(32):
        pages = daemon_stream(rng)
        jprof = j_core.neoprof_observe(jprof, jnp.asarray(pages), jpp)
        tprof = t_core.neoprof_observe(tprof, torch.from_numpy(pages), tpp)
        jprof, jtier = jd.tick(jprof, jtier)
        tprof, ttier = td.tick(tprof, ttier)
        hold(ttier, jtier, td.stats, jd.stats, f"tick {step + 1}")
    np.testing.assert_array_equal(tprof.sketch.counts.numpy(),
                                  np.asarray(jprof.sketch.counts))
    assert int(tprof.theta) == int(jprof.theta)
    resident = set(ttier.slot_page[ttier.slot_page >= 0].tolist())
    assert len(resident & set(range(900, 916))) >= 12


def test_expert_cache_tracks_router_stream_as_reference():
    cfg = dict(n_groups=4, n_experts=16, hot_slots=4, quota_pages=16)
    jc = j_expert.ExpertCache(j_expert.ExpertTierConfig(**cfg))
    tc = t_expert.ExpertCache(t_expert.ExpertTierConfig(**cfg), device="cpu")
    jc.prof = jc.daemon.cmd.set_threshold(jc.prof, 4)
    tc.prof = tc.daemon.cmd.set_threshold(tc.prof, 4)
    rng = np.random.default_rng(1)
    for step in range(16):
        idx = rng.choice(4, size=(4, 1, 2, 16, 2)).astype(np.int32)
        jc.observe_step(jnp.asarray(idx))
        tc.observe_step(idx)
        jc.tick()
        tc.tick()
        hold(tc.tier, jc.tier, tc.handle.stats, jc.handle.stats, f"tick {step + 1}")
    np.testing.assert_array_equal(tc.residency(), jc.residency())
    hot_pages = {g * 16 + e for g in range(4) for e in range(4)}
    assert len(set(np.nonzero(tc.residency() >= 0)[0].tolist()) & hot_pages) >= 8
    assert tc.hit_rate() == jc.hit_rate()


def test_embed_cache_hit_rate_improves_as_reference():
    cfg = dict(vocab=8192, hot_slots=32, quota_pages=16)
    jc = j_embed.EmbedCache(j_embed.EmbedTierConfig(**cfg))
    tc = t_embed.EmbedCache(t_embed.EmbedTierConfig(**cfg), device="cpu")
    assert t_embed.ROWS_PER_PAGE == j_embed.ROWS_PER_PAGE == 64
    jc.prof = jc.daemon.cmd.set_threshold(jc.prof, 4)
    tc.prof = tc.daemon.cmd.set_threshold(tc.prof, 4)
    rng = np.random.default_rng(2)
    rates = []
    for step in range(24):
        toks = (rng.zipf(1.5, 512) % 8192).astype(np.int32)
        jc.observe_tokens(jnp.asarray(toks))
        tc.observe_tokens(torch.from_numpy(toks))
        jc.tick()
        tc.tick()
        hold(tc.tier, jc.tier, tc.handle.stats, jc.handle.stats, f"tick {step + 1}")
        assert tc.hit_rate() == jc.hit_rate()
        rates.append(tc.hit_rate())
    assert rates[-1] > rates[4]
    # the legacy daemon view reads the same
    for k in ("total_fast", "total_slow", "total_promoted", "total_ping_pong",
              "theta_trace", "bw_trace", "pp_trace"):
        assert getattr(tc.daemon.state, k) == getattr(jc.daemon.state, k), k
    assert tc.daemon.policy.theta == jc.daemon.policy.theta
    assert tc.daemon.policy.p == pytest.approx(float(jc.daemon.policy.p), abs=0)


def test_legacy_adapters_warn_and_forward_data_plane(monkeypatch):
    """The twin of the reference's test of that name: the warning names the
    port's multiplexed daemon, points at the caller, and ``bind_data`` /
    ``read_rows`` / ``migration_bytes`` forward to the unified layer; the
    rows read and the bytes moved are the reference's."""
    monkeypatch.setitem(j_ho._probe_cache, "kinds", ("device",))   # ROADMAP C0
    cfg = dict(vocab=256, hot_slots=4, rows_per_page=64, quota_pages=4)
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.tiering\.NeoMemDaemon.*Migrating off the "
                            r"legacy adapters") as rec:
        tc = t_embed.EmbedCache(t_embed.EmbedTierConfig(**cfg), device="cpu")
    assert rec[0].filename == __file__
    jc = j_embed.EmbedCache(j_embed.EmbedTierConfig(**cfg))
    data = np.arange(4 * 64 * 8, dtype=np.float32).reshape(4, 64, 8)
    jc.bind_data(jnp.asarray(data))
    tc.bind_data(torch.from_numpy(data))
    for c in (jc, tc):
        c.handle.mem.enqueue([2])
        c.tick()
    assert tc.migration_bytes == jc.migration_bytes > 0
    ids = np.array([2, 0, 3])
    got = tc.read_rows(ids).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.read_rows(ids)))
    np.testing.assert_array_equal(got[:1], data[2:3])
    hold(tc.tier, jc.tier, tc.handle.stats, jc.handle.stats, "data plane")


def test_legacy_daemon_warns():
    with pytest.warns(DeprecationWarning, match="deprecation shim") as rec:
        t_core.NeoMemDaemon(t_core.NeoProfParams(sketch=t_core.SketchParams(width=1 << 8)),
                            t_core.TierParams(num_pages=16, num_slots=4, quota_pages=4),
                            t_core.DaemonParams(quota_pages=4), device="cpu")
    assert rec[0].filename == __file__
    assert "core.daemon.NeoMemDaemon" in str(rec[0].message)


@pytest.mark.parametrize("make", [
    lambda: t_expert.ExpertCache(t_expert.ExpertTierConfig(n_groups=2, n_experts=4,
                                                           hot_slots=2), device="cpu"),
    lambda: t_kv.KVTier(t_kv.KVTierConfig(n_pages_total=16, hot_slots=4), device="cpu"),
], ids=["ExpertCache", "KVTier"])
def test_other_legacy_adapters_warn(make):
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.tiering\.NeoMemDaemon"):
        make()


def test_kv_tier_config_and_geometry_as_reference():
    jcfg = j_kv.KVTierConfig(n_pages_total=16, hot_slots=4)
    tcfg = t_kv.KVTierConfig(n_pages_total=16, hot_slots=4)
    assert vars(tcfg) == vars(jcfg)
    jk, tk = j_kv.KVTier(jcfg), t_kv.KVTier(tcfg, device="cpu")
    assert tk.spec.touch_cap == jk.spec.touch_cap == 1 << 14
    assert (tk.prof_params.sketch.width, tk.prof_params.sketch.depth) == (
        jk.prof_params.sketch.width, jk.prof_params.sketch.depth) == (1 << 14, 2)
    assert tk.handle.resource.mass_threshold == jk.handle.resource.mass_threshold
    assert vars(t_expert.ExpertTierConfig(2, 4, 2)) == vars(j_expert.ExpertTierConfig(2, 4, 2))
    assert vars(t_embed.EmbedTierConfig(256, 4)) == vars(j_embed.EmbedTierConfig(256, 4))


def test_expert_cache_single_spec_for_tier_and_daemon():
    """The twin of the reference's regression: one ResourceSpec flows to
    both the tier and the daemon."""
    cfg = t_expert.ExpertTierConfig(n_groups=3, n_experts=8, hot_slots=2,
                                    quota_pages=16)
    cache = t_expert.ExpertCache(cfg, device="cpu")
    spec_tp = cache.spec.tier_params()
    assert cache.daemon.tp == spec_tp
    assert cache.tier.page_slot.shape[0] == spec_tp.num_pages == 3 * 8
    assert cache.tier.slot_page.shape[0] == spec_tp.num_slots == 3 * 2
    assert cache.handle.mem.quota == cfg.quota_pages


def test_observe_pages_with_touch_pages_as_reference():
    """P6: ``ResourceHandle.observe_pages`` feeds an encoded stream to the
    sketch and a separate one to the tier's hit accounting, as the
    reference's (the quickstart's slow-tier-only profiling)."""
    kw = dict(name="demo", n_pages=512, hot_slots=64, quota_pages=16,
              sketch_width=1 << 10)
    dp = dict(migration_interval=1, threshold_update_period=4, clear_interval=16)
    jd = j_tm.NeoMemDaemon(j_tm.DaemonParams(**dp))
    td = t_tm.NeoMemDaemon(t_tm.DaemonParams(**dp), device="cpu")
    jh = jd.register(j_tm.StreamResource(j_tm.ResourceSpec(**kw)))
    th = td.register(t_tm.StreamResource(t_tm.ResourceSpec(**kw)),
                     seeds=key_seeds(2, 1 << 10))
    rng = np.random.default_rng(3)
    for step in range(24):
        pages = np.concatenate([rng.integers(400, 440, 200),
                                rng.integers(0, 512, 56)]).astype(np.int32)
        slow = pages[np.asarray(jh.state.tier.page_slot)[pages] < 0]
        blk = np.full(len(pages), -1, np.int32)
        blk[: len(slow)] = slow
        jh.observe_pages(jnp.asarray(blk), touch_pages=jnp.asarray(pages))
        th.observe_pages(torch.from_numpy(blk), touch_pages=torch.from_numpy(pages))
        jd.tick()
        td.tick()
        hold(th.state.tier, jh.state.tier, th.stats, jh.stats, f"tick {step + 1}")
        assert th.hit_rate() == jh.hit_rate()
    assert th.stats.promoted > 0


def _kv_stream(rng, n):
    mass = rng.random(n).astype(np.float32) ** 4
    return mass, rng.integers(0, 64, n).astype(np.int32)


MIGRATE_KINDS = {
    # kind: (make_resource kwargs, one step's observation from an rng)
    "stream": (None, None),
    "kv": (dict(mass_threshold=0.02), lambda rng: _kv_stream(rng, 48)),
    "experts": (dict(n_experts=8), lambda rng: (rng.choice(
        4, size=(8, 1, 2, 8, 2)).astype(np.int32),)),
    "embeddings": (dict(rows_per_page=8), lambda rng: (
        (rng.zipf(1.4, 256) % 512).astype(np.int32),)),
}


@pytest.mark.parametrize("kind", list(MIGRATE_KINDS))
def test_migrate_fn_sees_reference_batches(kind):
    """P7: ``StreamResource(spec, migrate_fn=f)`` and the three resources
    that pass ``migrate_fn`` through call ``f`` with each promotion batch,
    the reference's (promoted pages, victim slots) in the same order."""
    kw, draw = MIGRATE_KINDS[kind]
    spec = dict(name=kind, n_pages=64, hot_slots=8, quota_pages=4,
                sketch_width=1 << 8)
    calls = {"ref": [], "port": []}

    def hook(side):
        return lambda promoted, victims: calls[side].append(
            (np.asarray(promoted).tolist(), np.asarray(victims).tolist()))
    if kind == "stream":
        jr = j_tm.StreamResource(j_tm.ResourceSpec(**spec), migrate_fn=hook("ref"))
        tr_ = t_tm.StreamResource(t_tm.ResourceSpec(**spec), migrate_fn=hook("port"))
    else:
        jr = j_tm.make_resource(kind, j_tm.ResourceSpec(**spec), migrate_fn=hook("ref"), **kw)
        tr_ = t_tm.make_resource(kind, t_tm.ResourceSpec(**spec), migrate_fn=hook("port"),
                                 **kw)
    jd = j_tm.NeoMemDaemon(j_tm.DaemonParams(threshold_update_period=4,
                                             clear_interval=16))
    td = t_tm.NeoMemDaemon(t_tm.DaemonParams(threshold_update_period=4,
                                             clear_interval=16), device="cpu")
    jh, th = jd.register(jr), td.register(tr_, seeds=key_seeds(2, 1 << 8))
    rng = np.random.default_rng(4)
    for step in range(20):
        if kind == "stream":
            pages = np.concatenate([rng.integers(40, 48, 96),
                                    rng.integers(0, 64, 32)]).astype(np.int32)
            jh.observe_pages(jnp.asarray(pages))
            th.observe_pages(torch.from_numpy(pages))
        else:
            obs = draw(rng)
            jh.observe(*[jnp.asarray(x) for x in obs])
            th.observe(*[torch.from_numpy(x) for x in obs])
        jd.tick()
        td.tick()
    assert calls["ref"], "the reference promoted nothing: the case is vacuous"
    assert calls["port"] == calls["ref"]
    hold(th.state.tier, jh.state.tier, th.stats, jh.stats, kind)
