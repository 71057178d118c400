"""The port's slow-tier codecs (``tiering/codec.py``) and the scaled slow
store of the data plane against the reference's, on the CPU.

Ports of ``tests/test_codec.py``'s codec and tier-store cases (those that
do not touch ZeRO-1).  int8 payloads and scales are held bitwise to
``repro.tiering.codec`` and to the reference's ``TieredMemory`` through a
sequence of binds, promotions, demotions, writes and copies; decoded rows
within one int8 quantum (``scale / 2``) of the native rows, plus the bf16
half-ulp the fast dtype re-rounds into.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.dist.host_offload as ho  # noqa: E402
import repro.tiering as j_tm  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.tiering import codec as j_codec  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.tiering import codec as t_codec  # noqa: E402
from repro_torch.tiering import memory as t_memory  # noqa: E402
from repro_torch.tiering import resource as t_resource  # noqa: E402
from repro_torch.tiering.stats import TierStats  # noqa: E402

ROW_SHAPE = (2, 3)


@pytest.fixture(autouse=True)
def device_tier_probe(monkeypatch):
    """Keep the reference's slow tier a device array on the CPU backend
    (ROADMAP C0)."""
    monkeypatch.setitem(ho._probe_cache, "kinds", ("device",))


def _np(t) -> np.ndarray:
    """A port tensor as numpy; bf16 as float32 (exact)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _j(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _rows(seed, shape, scale=1.0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(dtype)


# -- the int8 core ----------------------------------------------------------------

@pytest.mark.parametrize("jitted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mag", [1e-3, 1.0, 40.0, 1e3])
def test_int8_payload_and_scale_bitwise(dtype, mag, jitted):
    """``encode_rows("int8")`` against the reference, run eagerly (as it
    encodes a store at bind time) and under ``jax.jit`` (as its write
    verbs do, where the scale's division by 127 compiles to a
    multiplication by the reciprocal; the port's ``by_reciprocal``):
    payload and per-row scales bitwise over 400 rows, an outlier row and a
    zero row among them; the decode bitwise too."""
    rows = _rows(int(mag * 7) % 97, (400, 4, 5), scale=mag)
    rows[3, 1, 2] = 50 * mag                  # an outlier widens its own row
    rows[5] = 0.0
    j_rows = jnp.asarray(rows, dtype)
    t_rows = torch.from_numpy(_j(j_rows).copy()).to(getattr(torch, dtype))
    encode = functools.partial(j_codec.encode_rows, "int8")
    jq, js = (jax.jit(encode) if jitted else encode)(j_rows)
    tq, ts = t_codec.encode_rows("int8", t_rows, by_reciprocal=jitted)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        _np(t_codec.decode_rows(tq, ts, t_rows.dtype)),
        _j(j_codec.decode_rows(jq, js, j_rows.dtype)))
    # one quantum, plus the float32 rounding of q * scale
    err = np.abs(_np(t_codec.decode_rows(tq, ts, torch.float32)) - _j(j_rows))
    bound = ts.numpy()[:, None, None] / 2 + np.abs(_j(j_rows)) * 2.0 ** -22
    assert np.all(err <= bound)


def test_all_zero_row_quantizes_exactly():
    """The 0/0 guard: an all-zero row gets scale 1 and decodes to zeros."""
    q, scale = t_codec.quantize_int8(torch.zeros((3, 4)), axes=(1,))
    assert torch.equal(scale, torch.ones(3))
    assert torch.equal(t_codec.dequantize_int8(q, scale, torch.float32),
                       torch.zeros((3, 4)))
    q, scale = t_codec.quantize_int8(torch.zeros((2, 5)))       # whole tensor
    assert float(scale) == 1.0 and not q.any()


def test_fp32_codec_is_identity_for_bf16():
    rows = torch.from_numpy(_rows(0, (6, 4))).to(torch.bfloat16)
    payload, scale = t_codec.encode_rows("fp32", rows)
    assert scale is None and payload.dtype == torch.float32
    assert torch.equal(t_codec.decode_rows(payload, None, torch.bfloat16), rows)


def test_wire_row_bytes_schedule():
    for dtype in ("bfloat16", torch.bfloat16):
        assert t_codec.wire_row_bytes("none", ROW_SHAPE, dtype) == 12
        assert t_codec.wire_row_bytes("fp32", ROW_SHAPE, dtype) == 24
        assert t_codec.wire_row_bytes("int8", ROW_SHAPE, dtype) == 6 + 4
        for codec in t_codec.CODECS:
            assert t_codec.wire_row_bytes(codec, ROW_SHAPE, dtype) == \
                j_codec.wire_row_bytes(codec, ROW_SHAPE, "bfloat16")
    with pytest.raises(KeyError):
        t_codec.wire_row_bytes("zstd", ROW_SHAPE, "bfloat16")


# -- the tier store ------------------------------------------------------------------

def _spec_kw(codec):
    return dict(name="embeddings", n_pages=32, hot_slots=6, quota_pages=4,
                sketch_width=1 << 8, row_shape=ROW_SHAPE, row_dtype="bfloat16",
                slow_codec=codec)


def _bound_pair(codec: str):
    """The same bf16 store bound under ``codec`` in the reference and in
    the port."""
    data = jnp.asarray(_rows(1, (32,) + ROW_SHAPE), jnp.bfloat16)
    jmem = j_tm.TieredMemory.from_spec(j_tm.ResourceSpec(**_spec_kw(codec)))
    jmem.bind_data(data)
    tspec = t_resource.ResourceSpec(**_spec_kw(codec))
    tmem = t_memory.TieredMemory.from_spec(tspec, device="cpu")
    tmem.bind_data(torch.from_numpy(_j(data).copy()).to(torch.bfloat16))
    return jmem, tmem, tspec, data


def _same_buffers(jmem, tmem, msg):
    for name in ("fast", "slow", "scale"):
        jb, tb = getattr(jmem.buffers, name), getattr(tmem.buffers, name)
        assert (jb is None) == (tb is None), f"{name} {msg}"
        if jb is not None:
            assert str(tb.dtype).split(".")[-1] == str(np.asarray(jb).dtype), name
            np.testing.assert_array_equal(_np(tb), _j(jb), err_msg=f"{name} {msg}")


@pytest.mark.parametrize("codec", ["none", "fp32", "int8"])
def test_store_matches_reference_through_the_data_plane(codec):
    """Bind, promote (decode into the fast tier), write (re-encode both
    tiers), promote again (demotion write-back re-encodes) and copy
    (wire format verbatim): fast rows, slow payload and scales bitwise the
    reference's after every verb, and equal wire bytes metered."""
    jmem, tmem, _, _ = _bound_pair(codec)
    js, ts = jmem.init(), tmem.init()
    jst, tst = j_tm.TierStats(name="e"), TierStats(name="e")
    _same_buffers(jmem, tmem, "at bind")
    new = _rows(2, (24,) + ROW_SHAPE, scale=3.0)
    for step, pages in enumerate([[3, 9, 21], [4, 5, 6, 7], [8, 10, 11, 12]]):
        jmem.enqueue(pages)
        tmem.enqueue(pages)
        js, jev = jmem.migrate(js, jst)
        ts, tev = tmem.migrate(ts, tst)
        assert jmem.apply_migration(jev, jst) == tmem.apply_migration(tev, tst)
        _same_buffers(jmem, tmem, f"after epoch {step}")
        ids = np.random.default_rng(step).permutation(32)[:24]   # distinct
        jmem.write_rows(js, ids, jnp.asarray(new, jnp.bfloat16))
        tmem.write_rows(ts, ids, torch.from_numpy(new).to(torch.bfloat16))
        _same_buffers(jmem, tmem, f"after write {step}")
        new = new * -1.5
    src, dst = np.array([9, 13, 0]), np.array([30, 31, 4])
    assert jmem.copy_rows(js, src, dst) == tmem.copy_rows(ts, src, dst) == 3
    _same_buffers(jmem, tmem, "after copy")
    ids = np.arange(32)
    np.testing.assert_array_equal(_np(tmem.read_rows(ts, ids)),
                                  _j(jmem.read_rows(js, ids)))
    np.testing.assert_array_equal(_np(tmem.lookup_rows(ts, ids)),
                                  _j(jmem.lookup_rows(js, jnp.asarray(ids))))
    assert tst.migration_bytes == jst.migration_bytes > 0


def test_int8_store_serves_within_one_quantum():
    """Slow-fallback reads, the lookup_rows path and promoted fast-tier
    reads all decode within scale/2 per element (+ the bf16 half-ulp)."""
    _, mem, _, data = _bound_pair("int8")
    state, stats = mem.init(), TierStats(name="embeddings")
    native = _j(data)
    scale = mem.buffers.scale.numpy()
    ids = np.array([3, 9, 21])
    bound = (scale[ids].reshape(-1, 1, 1) / 2.0
             + np.abs(native[ids]) * 2.0 ** -8 + 1e-7)
    for reader in (lambda: mem.read_rows(state, ids),
                   lambda: mem.lookup_rows(state, torch.as_tensor(ids))):
        assert np.all(np.abs(_np(reader()) - native[ids]) <= bound)
    mem.enqueue(ids.tolist())
    state, event = mem.migrate(state, stats)
    assert mem.apply_migration(event, stats) > 0
    _, hit = t_memory.lookup(state, torch.as_tensor(ids))
    assert bool(hit.all())
    assert mem.buffers.fast.dtype == torch.bfloat16   # decoded once, on promotion
    assert np.all(np.abs(_np(mem.read_rows(state, ids)) - native[ids]) <= bound)


def test_int8_wire_bytes_metered_not_native():
    _, mem, spec, _ = _bound_pair("int8")
    assert spec.wire_row_bytes == t_codec.wire_row_bytes("int8", ROW_SHAPE,
                                                         "bfloat16") == 10
    assert mem.row_bytes == spec.wire_row_bytes
    assert spec.quota_bytes == 2 * spec.quota_pages * spec.wire_row_bytes
    state, stats = mem.init(), TierStats(name="embeddings")
    mem.enqueue([1, 2, 3])
    state, event = mem.migrate(state, stats)
    assert mem.apply_migration(event, stats) == 3 * spec.wire_row_bytes
    assert stats.max_epoch_bytes <= spec.quota_bytes


def test_copy_rows_preserves_wire_format():
    """The publish verb duplicates payload AND scale verbatim: destination
    pages decode bitwise like their sources."""
    _, mem, _, _ = _bound_pair("int8")
    state = mem.init()
    src, dst = np.array([4, 7]), np.array([30, 31])
    mem.copy_rows(state, src, dst)
    slow, scale = mem.buffers.slow, mem.buffers.scale
    assert torch.equal(slow[dst], slow[src]) and torch.equal(scale[dst], scale[src])
    assert torch.equal(mem.read_rows(state, dst), mem.read_rows(state, src))
    assert mem.pages_written(dst).all()


def test_write_rows_reencodes():
    """An owner refresh on an int8 store re-quantizes: the slow copy
    decodes to the NEW rows within one quantum of the new row scale."""
    _, mem, _, _ = _bound_pair("int8")
    state = mem.init()
    ids = np.array([11, 12])
    new = torch.from_numpy(_rows(2, (2,) + ROW_SHAPE, scale=3.0)).to(torch.bfloat16)
    mem.write_rows(state, ids, new)
    q, s = t_codec.encode_rows("int8", new, by_reciprocal=True)
    assert torch.equal(mem.buffers.slow[ids], q) and torch.equal(mem.buffers.scale[ids], s)
    scale = s.numpy().reshape(-1, 1, 1)
    err = np.abs(_np(mem.read_rows(state, ids)) - _np(new))
    assert np.all(err <= scale / 2.0 + np.abs(_np(new)) * 2.0 ** -8 + 1e-7)


def test_codec_none_is_the_native_store_bitwise():
    """``none``: the slow store is the native payload, no scale vector,
    native wire bytes, reads bitwise the payload."""
    _, mem, spec, data = _bound_pair("none")
    assert mem.buffers.scale is None and mem.buffers.slow.dtype == torch.bfloat16
    assert spec.wire_row_bytes == spec.row_bytes
    state = mem.init()
    np.testing.assert_array_equal(_np(mem.read_rows(state, np.arange(32))), _j(data))
    assert mem.tier_view(state)["scale"] is None


def test_int8_engine_serves_within_one_quantum():
    """A lane engine with ``slow_codec="int8"``: the embeddings store holds
    the table bitwise as the reference's codec encodes it, and the in-step
    embedding read through the tier view (decoded on the device) is the
    reference's decode bitwise, within one quantum of the table; the KV
    store's scales start as the zero-row guard's 1."""
    cfg = j_smoke("llama3.2-3b")
    jparams = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config("llama3.2-3b"), params, t_engine.ServeConfig(
            max_seq=48, paged=True, page_t=4, hot_slots=5, lanes=2,
            resources=("embeddings",), embed_rows_per_page=8,
            slow_codec="int8"), device="cpu")
    table = jparams["embed"]["table"].reshape(-1, 8, cfg.d_model)
    jq, js = j_codec.encode_rows("int8", table)
    emb = eng.daemon["embeddings"].mem
    np.testing.assert_array_equal(emb.buffers.slow.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(emb.buffers.scale.numpy(), np.asarray(js))
    assert emb.row_bytes == 8 * cfg.d_model + 4
    kv = eng.daemon["kv"].mem
    assert kv.buffers.slow.dtype == torch.int8 and bool((kv.buffers.scale == 1).all())
    tok = torch.as_tensor([[5], [200]])
    got = _np(t_dec._embed_tokens(params, tok, eng._tier_reads()))[:, 0]
    want = _j(j_codec.decode_rows(jq, js, jnp.bfloat16)).reshape(-1, cfg.d_model)
    np.testing.assert_array_equal(got, want[[5, 200]])
    dense = _j(jparams["embed"]["table"])[[5, 200]]
    bound = np.asarray(js)[[0, 25]][:, None] / 2 + np.abs(dense) * 2.0 ** -8 + 1e-7
    assert np.all(np.abs(got - dense) <= bound)
