"""The port's asynchronous data plane (DESIGN.md §15) against the reference,
on the CPU.

Ports of ``tests/test_async_migration.py``: each case runs the same inputs
(rows drawn with numpy from a seed, the reference's sketch seeds through
``sketch_seeds_from_jax``) through ``repro.tiering`` and
``repro_torch.tiering``; where the reference case patches
``migrate.token_ready`` to hold an epoch in flight, both packages' are
patched alike.  Reads are compared bitwise, placement tables, ``TierStats``
integers and ``inflight_bytes`` exactly.  The engine and scheduler cases
run the port's synchronous and asynchronous arms, which must be bitwise
equal, and one disaggregated, preempting scheduler scenario runs through
the reference in a subprocess (``test_torch_reuse.py``'s ``drive``, its
commits made deterministic by a blocking ``token_ready``): every token,
step, TierStats integer, placement table and θ trace equal.

Port only: the staging design (only the promoted rows are staged, and
committed into the live fast buffer) gives the reference's whole-buffer
clone bitwise under mid-epoch ``write_rows``, ``write_pages`` and
``copy_rows`` on promoted, evicted and untouched pages, under both codecs
that keep rows in another format; and ``chip_smoke.py``'s CPU replay,
given the commit ticks of a run whose tokens were held unready for a few
ticks, reproduces that run's integers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.dist.host_offload as ho  # noqa: E402
import repro.tiering as j_tm  # noqa: E402
from repro.tiering import migrate as j_migrate  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import sketch_seeds_from_jax  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.tiering import daemon as t_daemon  # noqa: E402
from repro_torch.tiering import memory as t_memory  # noqa: E402
from repro_torch.tiering import migrate as t_migrate  # noqa: E402
from repro_torch.tiering import resource as t_resource  # noqa: E402
from repro_torch.tiering.stats import TierStats  # noqa: E402
from test_torch_reuse import (CHIP, port_params, port_run,  # noqa: E402,F401
                              reference_rounding, start_reference,
                              stop_reference, wait_reference)

ROWS = np.arange(32 * 4, dtype=np.float32).reshape(32, 4) * 0.5
INTS = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
        "migration_bytes", "last_epoch_bytes", "max_epoch_bytes", "quota_bytes",
        "migration_epochs", "flush_bytes", "inflight_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor runs slow down many-fold when each worker
    also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def device_tier_probe(monkeypatch):
    """Keep the reference's slow tier a device array on the CPU backend
    (ROADMAP C0)."""
    monkeypatch.setitem(ho._probe_cache, "kinds", ("device",))


def _hold(monkeypatch, ready: bool) -> None:
    """Patch both packages' readiness probe alike."""
    monkeypatch.setattr(j_migrate, "token_ready", lambda t: ready)
    monkeypatch.setattr(t_migrate, "token_ready", lambda t: ready)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ints(stats) -> dict:
    row = stats.as_row() if hasattr(stats, "as_row") else stats
    return {k: int(row[k]) for k in INTS}


def _same_tier(js, ts) -> None:
    for f in ("page_slot", "slot_page"):
        np.testing.assert_array_equal(_np(getattr(ts.tier, f)),
                                      np.asarray(getattr(js.tier, f)), err_msg=f)


# -- one resource (TieredMemory) --------------------------------------------------

def _mem_pair(async_plane, quota=4, codec="none", rows=ROWS):
    """The reference's and the port's TieredMemory over ``rows``."""
    kw = dict(name="t", n_pages=32, hot_slots=8, quota_pages=quota, row_shape=(4,),
              row_dtype="float32", slow_codec=codec)
    jm = j_tm.TieredMemory.from_spec(j_tm.ResourceSpec(**kw), daemon_params=(
        j_tm.DaemonParams(migration_interval=1, async_plane=async_plane)))
    jm.bind_data(rows.copy())
    tm = t_memory.TieredMemory.from_spec(
        t_resource.ResourceSpec(**kw), daemon_params=t_memory.DaemonParams(
            migration_interval=1, async_plane=async_plane), device="cpu")
    tm.bind_data(torch.from_numpy(rows.copy()))
    js = jm.init()
    ts = tm.init(sketch_seeds_from_jax(np.asarray(js.prof.sketch.seeds)))
    return (jm, js, TierStats("t")), (tm, ts, TierStats("t"))


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_async_reads_bit_exact_vs_sync(codec):
    """One promotion stream through both planes of both packages: every
    read along the way bitwise equal to the reference's, the placement
    tables and byte meters equal, no stall in the async arm and a stall in
    the synchronous one.  Under the ``none`` codec the two planes' reads
    are bitwise equal.  Under ``int8`` they part, in both packages at the
    same ticks: the synchronous plane's demotion write-back re-quantizes a
    decoded row, which does not give its stored bytes back, and the async
    plane elides it (ROADMAP C7)."""
    rows = ROWS if codec == "none" else np.random.default_rng(4).normal(
        size=ROWS.shape).astype(np.float32)
    reads, j_reads, stats = {}, {}, {}
    for mode in (False, True):
        (jm, js, jst), (tm, ts, tst) = _mem_pair(mode, codec=codec, rows=rows)
        reads[mode] = []
        for i in range(12):
            for m in (jm, tm):
                m.enqueue([i % 32, (i * 3) % 32, (i * 7) % 32])
            js, _ = jm.tick(js, jst)
            ts, _ = tm.tick(ts, tst)
            got = _np(tm.read_rows(ts, torch.arange(32)))
            want = np.asarray(jm.read_rows(js, jnp.arange(32)))
            np.testing.assert_array_equal(got, want, err_msg=f"read {i}")
            assert _ints(tst) == _ints(jst), i
            _same_tier(js, ts)
            reads[mode].append(got)
            j_reads.setdefault(mode, []).append(want)
        jm.finalize_epoch(jst)
        tm.finalize_epoch(tst)
        assert _ints(tst) == _ints(jst)
        stats[mode] = tst
    def parted(r):
        return [i for i, (a, b) in enumerate(zip(r[False], r[True]))
                if not np.array_equal(a, b)]
    assert parted(reads) == parted(j_reads)
    assert (parted(reads) == []) == (codec == "none")
    s_sync, s_async = stats[False], stats[True]
    assert s_async.migration_bytes == s_sync.migration_bytes > 0
    assert s_async.inflight_bytes == 0 and s_async.stall_s == 0.0
    assert s_sync.stall_s > 0.0


def test_reads_during_inflight_epoch_are_stale_and_exact(monkeypatch):
    """With the token held unready, reads resolve against the committed
    (pre-epoch) placement: promoted pages still serve from the slow tier,
    bitwise, in both packages."""
    (jm, js, jst), (tm, ts, tst) = _mem_pair(True)
    _hold(monkeypatch, False)
    for m in (jm, tm):
        m.enqueue([3, 9, 17])
    js, _ = jm.tick(js, jst)
    ts, _ = tm.tick(ts, tst)
    assert tm.busy and tst.inflight_bytes == jst.inflight_bytes > 0
    ids = [3, 9, 17]
    slots_ctl, _ = t_memory.lookup(ts, torch.tensor(ids))
    assert (_np(slots_ctl) >= 0).any()
    np.testing.assert_array_equal(_np(slots_ctl),
                                  np.asarray(j_tm.lookup(js, jnp.asarray(ids))[0]))
    seen = _np(tm.lookup_slots(ts, torch.tensor(ids)))
    np.testing.assert_array_equal(seen, -1)
    np.testing.assert_array_equal(seen, np.asarray(jm.lookup_slots(js, jnp.asarray(ids))))
    np.testing.assert_array_equal(_np(tm.read_rows(ts, torch.arange(32))), ROWS)
    np.testing.assert_array_equal(_np(tm.lookup_rows(ts, torch.arange(32))), ROWS)
    assert _ints(tst) == _ints(jst)


def test_no_epoch_n2_issued_before_n1_commit(monkeypatch):
    """While the in-flight epoch's token is not ready, further ticks neither
    commit nor issue, in lockstep with the reference; a direct issue while
    busy raises."""
    (jm, js, jst), (tm, ts, tst) = _mem_pair(True)
    _hold(monkeypatch, False)
    for m in (jm, tm):
        m.enqueue([1, 2, 3, 4])
    js, _ = jm.tick(js, jst)
    ts, _ = tm.tick(ts, tst)
    assert tm.busy
    fl, inflight0 = tm._inflight, tst.inflight_bytes
    for i in range(4):
        for m in (jm, tm):
            m.enqueue([(5 + i) % 32])
        js, jev = jm.tick(js, jst)
        ts, tev = tm.tick(ts, tst)
        assert tev is None and jev is None
        assert tm._inflight is fl
        assert tst.inflight_bytes == inflight0 and tst.migration_epochs == 0
        assert _ints(tst) == _ints(jst)
    _hold(monkeypatch, True)
    js, _ = jm.tick(js, jst)                 # commit N+1, issue N+2
    ts, _ = tm.tick(ts, tst)
    assert tst.migration_epochs == 1 and tst.migration_bytes == inflight0
    assert _ints(tst) == _ints(jst)
    _same_tier(js, ts)
    (_, _, _), (tm2, ts2, tst2) = _mem_pair(True)
    _hold(monkeypatch, False)
    tm2.enqueue([1, 2])
    ts2, _ = tm2.tick(ts2, tst2)
    ev = t_memory.MigrationEvent(torch.tensor([5], dtype=torch.int32),
                                 torch.tensor([0], dtype=torch.int32), 1)
    with pytest.raises(RuntimeError, match="in flight"):
        tm2.issue_migration(ts2, ev, tst2)


def test_write_mid_epoch_replays_onto_inflight_buffer(monkeypatch):
    """A write to a page the in-flight epoch promotes lands in the committed
    store and in the epoch: visible at once through the slow tier, and
    served from the fast tier after the commit, as in the reference."""
    (jm, js, jst), (tm, ts, tst) = _mem_pair(True)
    _hold(monkeypatch, False)
    for m in (jm, tm):
        m.enqueue([7, 21])
    js, _ = jm.tick(js, jst)
    ts, _ = tm.tick(ts, tst)
    assert tm.busy
    fresh = np.full((2, 4), 123.0, np.float32)
    jm.write_rows(js, jnp.asarray([7, 21]), jnp.asarray(fresh))
    tm.write_rows(ts, torch.tensor([7, 21]), torch.from_numpy(fresh))
    np.testing.assert_array_equal(_np(tm.read_rows(ts, torch.tensor([7, 21]))), fresh)
    _hold(monkeypatch, True)
    js, _ = jm.tick(js, jst)
    ts, _ = tm.tick(ts, tst)
    slots = _np(tm.lookup_slots(ts, torch.tensor([7, 21])))
    assert (slots >= 0).all()
    np.testing.assert_array_equal(slots, np.asarray(jm.lookup_slots(js, jnp.asarray([7, 21]))))
    np.testing.assert_array_equal(_np(tm.read_rows(ts, torch.tensor([7, 21]))), fresh)
    np.testing.assert_array_equal(_np(tm.buffers.fast), np.asarray(jm.buffers.fast))


# -- the staging design's equivalence (port only against the reference's clone) ----

KV_SHAPE = (1, 2, 1, 4)      # (G, T, hkv, dk + dv): one ring page row


def _kv_pair(codec):
    kw = dict(name="kv", n_pages=16, hot_slots=4, quota_pages=4, row_shape=KV_SHAPE,
              row_dtype="float32", slow_codec=codec)
    rows = np.random.default_rng(5).normal(size=(16,) + KV_SHAPE).astype(np.float32)
    jm = j_tm.TieredMemory.from_spec(j_tm.ResourceSpec(**kw), daemon_params=(
        j_tm.DaemonParams(migration_interval=1, async_plane=True)))
    jm.bind_data(rows.copy())
    tm = t_memory.TieredMemory.from_spec(
        t_resource.ResourceSpec(**kw), daemon_params=t_memory.DaemonParams(
            migration_interval=1, async_plane=True), device="cpu")
    tm.bind_data(torch.from_numpy(rows.copy()))
    js = jm.init()
    ts = tm.init(sketch_seeds_from_jax(np.asarray(js.prof.sketch.seeds)))
    return (jm, js, TierStats("kv")), (tm, ts, TierStats("kv"))


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_staging_equals_reference_clone_under_mid_epoch_writes(codec, monkeypatch):
    """The port stages only an epoch's promoted rows and commits them into
    the live fast buffer; the reference builds a whole second buffer and
    swaps it in.  With the fast tier full, an epoch that promotes two pages
    over two evicted ones is held in flight while ``write_rows``,
    ``write_pages`` and ``copy_rows`` land on promoted, evicted, untouched
    and cold pages: every read in between, and after the commit the whole
    fast buffer, the slow store and its scales, equal the reference's."""
    (jm, js, jst), (tm, ts, tst) = _kv_pair(codec)
    for m in (jm, tm):
        m.enqueue([0, 1, 2, 3])
    for _ in range(2):                        # issue, then commit: the tier is full
        js, _ = jm.tick(js, jst)
        ts, _ = tm.tick(ts, tst)
    _hold(monkeypatch, False)
    for m in (jm, tm):
        m.enqueue([5, 6])
    js, _ = jm.tick(js, jst)
    ts, _ = tm.tick(ts, tst)
    assert tm.busy and jm.busy
    ctl, seen = _np(ts.tier.page_slot), _np(tm.lookup_slots(ts, torch.arange(16)))
    promoted = [p for p in range(16) if ctl[p] >= 0 and seen[p] < 0]
    evicted = [p for p in range(16) if ctl[p] < 0 and seen[p] >= 0]
    untouched = [p for p in range(16) if ctl[p] >= 0 and seen[p] >= 0]
    assert sorted(promoted) == [5, 6] and len(evicted) == 2 and len(untouched) == 2
    rng = np.random.default_rng(9)

    def check(what):
        np.testing.assert_array_equal(_np(tm.read_rows(ts, torch.arange(16))),
                                      np.asarray(jm.read_rows(js, jnp.arange(16))),
                                      err_msg=what)
    # one write of each verb on a promoted, an evicted, an untouched and a cold page
    ids = [promoted[0], evicted[0], untouched[0], 9]
    rows = rng.normal(size=(4,) + KV_SHAPE).astype(np.float32)
    jm.write_rows(js, jnp.asarray(ids), jnp.asarray(rows))
    tm.write_rows(ts, torch.tensor(ids), torch.from_numpy(rows))
    check("write_rows")
    ids = [promoted[1], evicted[1], untouched[1], -1]       # (L*S,) = (1 * 4,)
    kp = rng.normal(size=(1, 1, 4, 2, 1, 2)).astype(np.float32)
    vp = rng.normal(size=(1, 1, 4, 2, 1, 2)).astype(np.float32)
    jm.write_pages(js, jnp.asarray(ids), jnp.asarray(kp), jnp.asarray(vp))
    tm.write_pages(ts, torch.tensor(ids), torch.from_numpy(kp), torch.from_numpy(vp))
    check("write_pages")
    src, dst = [10, 11, 12, 13], [promoted[0], evicted[1], untouched[0], 14]
    jm.copy_rows(js, jnp.asarray(src), jnp.asarray(dst))
    tm.copy_rows(ts, torch.tensor(src), torch.tensor(dst))
    check("copy_rows")
    _hold(monkeypatch, True)
    js, _ = jm.tick(js, jst)
    ts, _ = tm.tick(ts, tst)
    assert not tm.busy
    check("after the commit")
    np.testing.assert_array_equal(_np(tm.buffers.fast), np.asarray(jm.buffers.fast))
    np.testing.assert_array_equal(_np(tm.buffers.slow), np.asarray(jm.buffers.slow))
    if codec == "int8":
        np.testing.assert_array_equal(_np(tm.buffers.scale),
                                      np.asarray(jm.buffers.scale))
    assert _ints(tst) == _ints(jst)


# -- the multiplexed daemon -------------------------------------------------------

def _daemon_pair(async_plane, n_pages=32, quota=8):
    # threshold updates frozen: these cases pin the data plane's epochs
    table = np.random.default_rng(0).normal(size=(n_pages, 8, 16)).astype(np.float32)
    kw = dict(name="embeddings", n_pages=n_pages, hot_slots=4, quota_pages=quota,
              row_shape=(8, 16), row_dtype="float32")
    jd = j_tm.NeoMemDaemon(j_tm.DaemonParams(async_plane=async_plane,
                                             threshold_update_period=10_000))
    jh = jd.register(j_tm.make_resource("embeddings", j_tm.ResourceSpec(**kw),
                                        rows_per_page=8))
    jh.bind_data(table)
    td = t_daemon.NeoMemDaemon(t_memory.DaemonParams(
        async_plane=async_plane, threshold_update_period=10_000), device="cpu")
    th = td.register(t_resource.make_resource(
        "embeddings", t_resource.ResourceSpec(**kw), rows_per_page=8),
        seeds=sketch_seeds_from_jax(np.asarray(jh.state.prof.sketch.seeds)))
    th.bind_data(torch.from_numpy(table))
    return (jd, jh), (td, th)


def _drive(pair, steps=24, seed=0, shift=0):
    (jd, jh), (td, th) = pair
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = ((rng.zipf(1.5, size=64) + shift) % 32) * 8
        jh.observe(jnp.asarray(toks, jnp.int32))
        th.observe(torch.as_tensor(toks, dtype=torch.int32))
        jd.tick()
        td.tick()
        assert _ints(th.stats) == _ints(jh.stats)
        assert th.stats.pending == jh.stats.pending


def _same_daemon(pair) -> None:
    (jd, jh), (td, th) = pair
    _same_tier(jh.state, th.state)
    assert _ints(th.snapshot()) == _ints(jh.snapshot())
    assert th.mem.busy == jh.mem.busy


def test_daemon_excludes_busy_resource_from_quota_split(monkeypatch):
    """A busy resource is capped at 0 in the split and re-issues only after
    its commit, tick for tick as in the reference."""
    pair = _daemon_pair(True)
    _hold(monkeypatch, False)
    _drive(pair, steps=6)
    (_, jh), (_, th) = pair
    assert th.mem.busy and th.stats.migration_epochs == 0
    _same_daemon(pair)
    pending_while_busy = th.stats.pending
    _hold(monkeypatch, True)
    _drive(pair, steps=2, seed=1)
    assert th.stats.migration_epochs >= 1
    assert th.stats.pending <= pending_while_busy + 64
    _same_daemon(pair)


def test_state_dict_finalizes_inflight_epoch(monkeypatch):
    """Saving with an uncommitted epoch force-commits it; the state equals
    the reference's leaf for leaf, and resident pages read fast."""
    from repro_torch.ckpt.manager import tree_leaves
    pair = _daemon_pair(True)
    _hold(monkeypatch, False)
    _drive(pair, steps=6)
    (jd, jh), (td, th) = pair
    assert th.mem.busy and th.stats.inflight_bytes > 0
    jstates, tstates = jd.state_dict(), td.state_dict()
    assert not th.mem.busy and th.stats.inflight_bytes == 0
    for a, b in zip(tree_leaves(tstates), jax.tree.leaves(jstates)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    resident = np.flatnonzero(_np(tstates["embeddings"].tier.page_slot) >= 0)
    assert resident.size > 0
    assert (_np(th.mem.lookup_slots(th.state, torch.as_tensor(resident[:4]))) >= 0).all()
    _same_daemon(pair)


def test_load_state_drops_inflight_epoch(monkeypatch):
    """Restoring with an uncommitted epoch drops it, and the committed view
    realigns with the restored table; reads and tables as the reference's."""
    pair = _daemon_pair(True)
    (jd, jh), (td, th) = pair
    _drive(pair, steps=8)
    jd.finalize()
    td.finalize()
    jsaved = jax.tree.map(np.asarray, jd.state_dict())
    tsaved = td.state_dict()
    table = _np(th.state.tier.page_slot).copy()
    ref = _np(th.read_rows(torch.arange(8)))
    np.testing.assert_array_equal(ref, np.asarray(jh.read_rows(jnp.arange(8))))
    with monkeypatch.context() as m:
        m.setattr(j_migrate, "token_ready", lambda t: False)
        m.setattr(t_migrate, "token_ready", lambda t: False)
        _drive(pair, steps=8, seed=3, shift=16)
        assert th.mem.busy
    jd.load_state(jsaved)
    td.load_state(tsaved)
    assert not th.mem.busy and th.stats.inflight_bytes == 0
    np.testing.assert_array_equal(_np(th.state.tier.page_slot), table)
    np.testing.assert_array_equal(_np(th.read_rows(torch.arange(8))), ref)
    np.testing.assert_array_equal(ref, np.asarray(jh.read_rows(jnp.arange(8))))
    _same_daemon(pair)


def test_snapshot_folds_inflight_bytes(monkeypatch):
    """A snapshot taken mid-epoch folds the issued bytes into max_epoch_bytes
    (last <= max <= quota), integer for integer as the reference's."""
    pair = _daemon_pair(True)
    _hold(monkeypatch, False)
    _drive(pair, steps=6)
    (_, jh), (_, th) = pair
    assert th.mem.busy
    row = th.snapshot()
    assert row["inflight_bytes"] > 0
    assert row["last_epoch_bytes"] <= row["max_epoch_bytes"]
    assert row["inflight_bytes"] <= row["max_epoch_bytes"] <= row["quota_bytes"]
    assert _ints(row) == _ints(jh.snapshot())


# -- serve engine: sync/async A/B -------------------------------------------------

ARCH = "llama3.2-3b"
ENGINE_KW = dict(max_seq=64, paged=True, page_t=4, hot_slots=6,
                 migration_interval=4, resources=("embeddings",),
                 embed_hot_slots=4, kv_quota=8)


@pytest.fixture(scope="module")
def engine_pair(port_params):
    cfg = t_registry.get_smoke_config(ARCH)
    prompt = (np.arange(2 * 12).reshape(2, 12) * 7) % cfg.vocab
    out = []
    for flag in (False, True):
        eng = t_engine.ServeEngine(cfg, port_params, t_engine.ServeConfig(
            async_migration=flag, **ENGINE_KW), device="cpu")
        out += [eng, eng.generate(prompt, n_tokens=10)]
    return out


def test_engine_async_bit_exact(engine_pair):
    sync, out_s, anc, out_a = engine_pair
    np.testing.assert_array_equal(out_s, out_a)
    assert anc.daemon.dp.async_plane and all(
        h.mem.async_on for h in anc.daemon.resources.values())


def test_engine_async_zero_stall_equal_bytes(engine_pair):
    sync, _, anc, _ = engine_pair
    anc.daemon.finalize()                    # the end-of-run accounting barrier
    ss, sa = sync.tier_stats(), anc.tier_stats()
    assert any(row["migration_bytes"] for row in ss.values())
    for name in ss:
        assert ss[name]["migration_bytes"] == sa[name]["migration_bytes"], name
        assert ss[name]["flush_bytes"] == sa[name]["flush_bytes"], name
        assert sa[name]["stall_s"] == 0.0 and sa[name]["inflight_bytes"] == 0, name
        if ss[name]["migration_bytes"]:
            assert ss[name]["stall_s"] > 0.0, name
            assert sa[name]["overlap_bytes_per_decode_s"] > 0.0, name
        assert ss[name]["hit_rate"] == pytest.approx(sa[name]["hit_rate"], abs=0.2)
        np.testing.assert_array_equal(
            _np(sync.daemon[name].state.tier.page_slot),
            _np(anc.daemon[name].state.tier.page_slot))


# -- preempt/resume + disagg hand-off landing mid-epoch ----------------------------

_WORK = [("a", 1, 18, 5), ("b", 2, 6, 6), ("a", 3, 11, 4), ("b", 4, 21, 3)]


def _sched_case(async_plane):
    return {"kind": "ops",
            "serve": dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
                          migration_interval=2, resources=["embeddings"],
                          embed_hot_slots=4, embed_rows_per_page=8, kv_quota=8,
                          lanes=2, kv_segments=5, async_migration=async_plane),
            "tenants": [["a", 1.0], ["b", 1.0]],
            "ops": [["submit", t, s, n, m] for t, s, n, m in _WORK] + [["run"]],
            "sched": dict(preempt_patience=6, prefill_chunk=4, prefill_lanes=1,
                          temperature=0.0, seed=7)}


# the reference's probe blocks, so its commits are deterministic: every epoch
# commits at the tick after its issue, as the port's on the CPU
BLOCKING_PROBE = """
import repro.tiering.migrate as _migrate
def _ready(token):
    token.block_until_ready()
    return True
_migrate.token_ready = _ready
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    runs = start_reference(tmp_path_factory.mktemp("async_ref"),
                           [{"async-disagg": _sched_case(True)}],
                           prelude=BLOCKING_PROBE)
    yield runs
    stop_reference(runs)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    return wait_reference(_reference_runs)


def test_sched_disagg_preempt_bit_exact_under_async(reference, port_params,
                                                    reference_rounding,
                                                    monkeypatch):
    """Chunked disaggregated prefill, hand-offs and preemption under a tight
    patience, on the asynchronous plane: token for token the synchronous
    arm's, hand-offs and preemptions landing mid-epoch, and equal to the
    reference's run of the same scenario in every token, step, TierStats
    integer, placement table and θ trace."""
    out = {flag: port_run(_sched_case(flag), port_params, reference["seeds"])
           for flag in (False,)}
    # a hand-off's producer side preempts its lane too: preemptions proper
    # are the preempt_lane calls outside handoff_lane
    mid = {"preempt_lane": 0, "handoff_lane": 0, "install_handoff": 0}
    for verb in mid:
        fn = getattr(t_engine.ServeEngine, verb)

        def counted(self, *a, _fn=fn, _verb=verb, **kw):
            if any(h.mem.busy for h in self.daemon.resources.values()):
                mid[_verb] += 1
            return _fn(self, *a, **kw)
        monkeypatch.setattr(t_engine.ServeEngine, verb, counted)
    out[True] = port_run(_sched_case(True), port_params, reference["seeds"])
    assert out[True] == reference["async-disagg"]
    sync, anc = out[False], out[True]
    assert sync["requests"] == anc["requests"] and sync["report"] == anc["report"]
    assert anc["report"]["handoff"]["count"] == len(_WORK)
    preempted = sum(r[6] for r in anc["requests"])
    assert preempted > 0 and mid["install_handoff"] > 0, mid
    assert mid["preempt_lane"] - mid["handoff_lane"] > 0, mid
    assert any(s["migration_bytes"] for s in anc["stats"].values())


# -- chip_smoke.py's replay of a run whose commits were deferred -------------------

HOLD = 2     # ticks an issued epoch's token stays unready


def test_chip_smoke_replay_reproduces_deferred_commits(monkeypatch):
    """PHASE async's CPU replay, held to a run whose every epoch commits
    HOLD ticks after its issue (as a slow copy would on the card): given
    the recorded commit ticks it reproduces every promotion batch,
    placement table, θ trace, sketch, byte count and epoch count of all
    three resources; given the ticks of an undelayed run it does not."""
    cfg, params = CHIP._smoke_cpu("kimi-k2-1t-a32b")
    single = dict(CHIP.MOE_SINGLE, async_migration=True)
    eng = t_engine.ServeEngine(cfg, params, t_engine.ServeConfig(
        **dict(single, resources=tuple(single["resources"]))), device="cpu")
    names = ("experts", "embeddings", "kv")
    log = CHIP.record_experts(eng, cfg.moe.n_experts, names)
    epochs = CHIP.record_epochs(eng)
    issue, commit = t_migrate.issue_migrate, t_migrate.commit_rows

    def held(*args, **kw):          # the token: the tick from which it is ready
        rows, slots, _ = issue(*args, **kw)
        return rows, slots, eng.daemon._tick + HOLD
    monkeypatch.setattr(t_migrate, "issue_migrate", held)
    monkeypatch.setattr(t_migrate, "token_ready", lambda t: eng.daemon._tick >= t)
    monkeypatch.setattr(t_migrate, "wait_token", lambda t: None)
    monkeypatch.setattr(t_migrate, "commit_rows",
                        lambda fast, rows, slots, token: commit(fast, rows, slots, None))
    b, n, new = CHIP.MOE_PROMPT
    eng.generate(np.random.default_rng(0).integers(0, cfg.vocab, (b, n)), new)
    eng.daemon.finalize()
    monkeypatch.undo()
    lags = CHIP.epoch_ticks(epochs)
    assert sum(r["deferred"] for r in lags.values()) > 0, lags
    assert all(r["first_tick"] == 0 for r in lags.values()), lags
    got = CHIP.replay_experts(torch, eng, log, names, epochs)
    assert got["epochs"] > 0 and got["rows"] > 0
    undelayed = {n: {"issued": r["issued"], "committed": [t + 1 for t in r["issued"]]}
                 for n, r in epochs.items()}
    with pytest.raises(AssertionError):
        CHIP.replay_experts(torch, eng, log, names, undelayed)
