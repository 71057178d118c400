"""The port's checkpoint manager and tiering checkpoint against the
reference, on the CPU.

Ports of ``tests/test_ckpt.py``: the manager's round trip (bfloat16
leaves included), keep-N garbage collection, background save and atomic
commit on ``repro_torch.ckpt``, writing the reference's on-disk layout
file for file; and the tiering-state cases (a warm daemon's state through
the manager into a differently warmed daemon, geometry validation, a
``ServeEngine`` warm restart, stale pending cleared).  Cross-load: a
daemon state written by the reference's ``CheckpointManager`` restores
into the port (``load_state``) with every leaf bitwise the reference's own
restore, and a later tick promotes the same pages in both.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.dist.host_offload as ho  # noqa: E402
import repro.tiering as j_tm  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JManager  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager, tree_leaves  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import sketch_seeds_from_jax  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.tiering import daemon as t_daemon  # noqa: E402
from repro_torch.tiering import resource as t_resource  # noqa: E402
from test_torch_reuse import port_params  # noqa: E402,F401


@pytest.fixture(autouse=True)
def device_tier_probe(monkeypatch):
    """Keep the reference's slow tier a device array on the CPU backend
    (ROADMAP C0)."""
    monkeypatch.setitem(ho._probe_cache, "kinds", ("device",))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"b": {"w": torch.arange(10, dtype=torch.int32),
                  "s": torch.tensor(3.5, dtype=torch.float32)},
            "a": torch.randn((8, 16), generator=g),
            "h": torch.randn((4, 3), generator=g).to(torch.bfloat16)}


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    """Save and restore a tree of tensors bitwise (bfloat16 too); the step
    directory holds the files the reference's manager writes for the same
    tree, each with the same bytes and meta dtypes."""
    mgr = CheckpointManager(str(tmp_path / "port"))
    t = _tree()
    mgr.save(100, t)
    r = mgr.restore(100, _zeros(t))
    for a, b in zip(tree_leaves(t), tree_leaves(r)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    jt = {"b": {"w": jnp.arange(10, dtype=jnp.int32), "s": jnp.float32(3.5)},
          "a": jnp.asarray(_np(t["a"])),
          "h": jnp.asarray(_np(t["h"].float()), jnp.bfloat16)}
    JManager(str(tmp_path / "ref")).save(100, jt)
    port_dir, ref_dir = (tmp_path / d / "step_0000000100" for d in ("port", "ref"))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    for f in sorted(os.listdir(ref_dir)):
        if f.endswith(".npy"):
            a, b = np.load(port_dir / f), np.load(ref_dir / f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    import json
    meta = [json.loads((d / "meta.json").read_text()) for d in (port_dir, ref_dir)]
    assert meta[0]["dtypes"] == meta[1]["dtypes"]
    assert meta[0]["n_leaves"] == meta[1]["n_leaves"] == 4


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]          # keep=2 garbage-collected the rest


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(7)
    mgr.save(7, t, blocking=False)
    t["a"].zero_()                  # the snapshot was taken at save
    mgr.wait()
    assert mgr.latest_step() == 7
    r = mgr.restore(7, _zeros(t))
    assert torch.equal(r["b"]["w"], torch.arange(10, dtype=torch.int32))
    assert torch.equal(r["a"], _tree(7)["a"])


def test_no_partial_commit(tmp_path):
    """tmp_ dirs never count as checkpoints (atomic rename contract)."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "tmp_step_0000000009")
    assert mgr.latest_step() is None


# -- TieredMemoryState checkpointing (DESIGN.md §6) --------------------------------

TABLE = np.random.default_rng(0).normal(size=(32, 8, 16)).astype(np.float32)
SPEC = dict(name="embeddings", n_pages=32, hot_slots=4, quota_pages=8,
            row_shape=(8, 16), row_dtype="float32")


def _streams(seed, steps=32, shift=0):
    rng = np.random.default_rng(seed)
    return [((rng.zipf(1.5, size=64) + shift) % 32) * 8 for _ in range(steps)]


def _warm_daemon(stream_seed=0, seeds=None, steps=32):
    """A small embeddings-tiered port daemon over TABLE (the same table every
    time: a restarted server rebinds identical params), warmed by a seeded
    skewed stream so that its placement map holds promotions."""
    daemon = t_daemon.NeoMemDaemon(device="cpu")
    h = daemon.register(t_resource.make_resource(
        "embeddings", t_resource.ResourceSpec(**SPEC), rows_per_page=8), seeds=seeds)
    h.bind_data(torch.from_numpy(TABLE))
    for toks in _streams(stream_seed, steps):
        h.observe(torch.as_tensor(toks, dtype=torch.int32))
        daemon.tick()
    return daemon, h


def _warm_reference(stream_seed=0, steps=32):
    daemon = j_tm.NeoMemDaemon()
    h = daemon.register(j_tm.make_resource("embeddings", j_tm.ResourceSpec(**SPEC),
                                           rows_per_page=8))
    h.bind_data(TABLE)
    for toks in _streams(stream_seed, steps):
        h.observe(jnp.asarray(toks, jnp.int32))
        daemon.tick()
    return daemon, h


def test_tiering_state_roundtrip(tmp_path):
    """A warm daemon's state through the manager into a differently warmed
    daemon: placement and profiling state come back bitwise, the fast rows
    are refilled for resident pages."""
    daemon, h = _warm_daemon()
    promoted = np.flatnonzero(_np(h.state.tier.page_slot) >= 0)
    assert promoted.size > 0
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, daemon.state_dict())
    daemon2, h2 = _warm_daemon(stream_seed=99)
    daemon2.load_state(mgr.restore(3, daemon2.state_dict()))
    for a, b in zip(tree_leaves(daemon.state_dict()), tree_leaves(daemon2.state_dict())):
        assert torch.equal(a, b)
    ids = torch.as_tensor(promoted[:4])
    _, hit = h2.lookup(ids)
    assert bool(hit.all())
    np.testing.assert_array_equal(_np(h2.read_rows(ids)), TABLE[promoted[:4]])


def test_tiering_state_load_validates_geometry(tmp_path):
    daemon, _ = _warm_daemon()
    with pytest.raises(KeyError):
        daemon.load_state({"nope": daemon.state_dict()["embeddings"]})
    other = t_daemon.NeoMemDaemon(device="cpu")
    other.register(t_resource.make_resource("embeddings", t_resource.ResourceSpec(
        "embeddings", n_pages=16, hot_slots=2, quota_pages=4)))
    with pytest.raises(ValueError):              # 16-page map into 32-page tier
        daemon.load_state(other.state_dict())


def test_serve_engine_warm_restart(tmp_path, port_params):
    """A restarted ServeEngine resumes with the warm placement map: after
    load_tiering the tables and read_rows match the pre-restart server."""
    cfg = t_registry.get_smoke_config("llama3.2-3b")
    scfg = t_engine.ServeConfig(max_seq=32, resources=("embeddings",),
                                embed_hot_slots=4, embed_rows_per_page=8,
                                migration_interval=4)
    eng = t_engine.ServeEngine(cfg, port_params, scfg, device="cpu")
    prompt = (np.arange(2 * 10).reshape(2, 10) * 3) % 64   # skewed vocab use
    eng.generate(prompt, n_tokens=8)
    mgr = CheckpointManager(str(tmp_path))
    eng.save_tiering(mgr, step=1)
    eng2 = t_engine.ServeEngine(cfg, port_params, scfg, device="cpu")
    h1, h2 = eng.daemon["embeddings"], eng2.daemon["embeddings"]
    assert int((h2.state.tier.page_slot >= 0).sum()) == 0
    eng2.load_tiering(mgr, step=1)
    assert torch.equal(h1.state.tier.page_slot, h2.state.tier.page_slot)
    resident = np.flatnonzero(_np(h2.state.tier.page_slot) >= 0)
    assert resident.size > 0
    ids = torch.as_tensor(resident[:2])
    assert torch.equal(eng.read_rows("embeddings", ids), eng2.read_rows("embeddings", ids))


def test_restore_clears_stale_pending(tmp_path):
    """After load_state, a tick with no new observations promotes nothing:
    the pre-restore backlog is dropped."""
    daemon, _ = _warm_daemon()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, daemon.state_dict())
    daemon2, h2 = _warm_daemon(stream_seed=99)
    h2.mem.enqueue(np.arange(20))
    daemon2.load_state(mgr.restore(1, daemon2.state_dict()))
    assert len(h2.mem._pending) == 0
    before = h2.state.tier.page_slot.clone()
    daemon2.tick()
    assert torch.equal(before, h2.state.tier.page_slot)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A warm reference daemon's state, written by the reference's manager,
    restores into a port daemon (through the port's manager, then
    ``load_state``) with every leaf bitwise the reference's own restore;
    fed the same stream and the same queued hot pages on, both promote the
    same pages tick for tick."""
    jd, jh = _warm_reference()
    JManager(str(tmp_path)).save(5, jd.state_dict())
    jd2, jh2 = _warm_reference(stream_seed=99, steps=8)
    jd2.load_state(JManager(str(tmp_path)).restore(5, jd2.state_dict()))
    seeds = sketch_seeds_from_jax(np.asarray(jh2.state.prof.sketch.seeds))
    td, th = _warm_daemon(stream_seed=99, seeds=seeds, steps=8)
    td.load_state(CheckpointManager(str(tmp_path)).restore(5, td.state_dict()))
    for a, b in zip(tree_leaves(td.state_dict()), jax.tree.leaves(jd2.state_dict())):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    ids = np.arange(32)
    np.testing.assert_array_equal(_np(th.read_rows(torch.as_tensor(ids))),
                                  np.asarray(jh2.read_rows(jnp.asarray(ids))))
    promoted = 0
    for toks in _streams(7, steps=16, shift=16):
        jh2.mem.enqueue([int(toks[0]) // 8])
        th.mem.enqueue([int(toks[0]) // 8])
        jh2.observe(jnp.asarray(toks, jnp.int32))
        th.observe(torch.as_tensor(toks, dtype=torch.int32))
        jev, tev = jd2.tick().get("embeddings"), td.tick().get("embeddings")
        assert (jev is None) == (tev is None)
        if tev is not None:
            np.testing.assert_array_equal(_np(tev.promoted), np.asarray(jev.promoted))
            promoted += int((tev.promoted >= 0).sum())
    assert promoted > 0
    np.testing.assert_array_equal(_np(th.state.tier.page_slot),
                                  np.asarray(jh2.state.tier.page_slot))


@pytest.mark.parametrize("async_plane", [False, True])
def test_engine_async_save_and_restore(tmp_path, port_params, async_plane):
    """save_tiering commits an in-flight epoch (the state it writes is the
    control table, and the fast rows match it), load_tiering drops one and
    refills the fast rows: after the round trip every resident page's fast
    row equals its slow row, on either plane."""
    cfg = t_registry.get_smoke_config("llama3.2-3b")
    scfg = t_engine.ServeConfig(max_seq=32, resources=("embeddings",),
                                embed_hot_slots=4, embed_rows_per_page=8,
                                migration_interval=2, async_migration=async_plane)
    eng = t_engine.ServeEngine(cfg, port_params, scfg, device="cpu")
    tok = eng.prefill((np.arange(2 * 10).reshape(2, 10) * 3) % 64)
    h = eng.daemon["embeddings"]
    for _ in range(8):               # on to a tick that leaves an epoch in flight
        if h.mem.busy or not async_plane:
            break
        tok = eng.step(tok)
    assert h.mem.busy == async_plane
    mgr = CheckpointManager(str(tmp_path))
    eng.save_tiering(mgr, step=1)
    assert not h.mem.busy and h.stats.inflight_bytes == 0
    saved = h.state.tier.page_slot.clone()
    for _ in range(3):
        tok = eng.step(tok)
    eng.load_tiering(mgr, step=1)
    assert not h.mem.busy and torch.equal(h.state.tier.page_slot, saved)
    buf, slot_page = h.mem.buffers, h.state.tier.slot_page
    occupied = torch.nonzero(slot_page >= 0).reshape(-1)
    assert occupied.numel() > 0
    assert torch.equal(buf.fast[occupied], buf.slow[slot_page[occupied].long()])
