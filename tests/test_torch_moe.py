"""The port's MoE layers, the experts stream and the paged MoE decode against
the reference, on the CPU, from the reference's exact weights
(``params_from_jax``).

* Router, dispatch and tiered apply (float32 weights, in process):
  ``router_topk``'s ids bitwise and gates within 1e-6, ``_rank_in_bins``
  and ``_capacity`` exactly, ``moe_apply_ep`` and ``moe_apply_tiered``
  within 1e-5 (summation order only) with equal expert ids, at the
  kimi-k2 smoke shape and one other, with and without a router bias.  An
  exact tie between two experts' scores picks the lower expert id, as
  ``jax.lax.top_k`` does.
* ``ExpertStreamResource.encode_stream`` bitwise, -1 pads and subsampling
  included; the tier's page-table reads and writes at the out-of-range
  page ids the reference's prefill stream carries (ROADMAP C4) bitwise.
* ``decode_step_paged`` and ``prefill_paged`` on kimi-k2-smoke, float32:
  logits within 1e-4, page mass within 1e-5, router streams bitwise, the
  dense prologue's ring included.
* ``read_rows``: only the missed ids are read from the slow store, each
  once, and the rows are bitwise those of a read of every id.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.core import tiering as j_tiering  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.tiering import migrate as j_migrate  # noqa: E402
from repro.tiering import resource as j_resource  # noqa: E402
from repro.tiering import resources as j_resources  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import tiering as t_tiering  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.tiering import migrate as t_migrate  # noqa: E402
from repro_torch.tiering import resource as t_resource  # noqa: E402
from repro_torch.tiering import resources as t_resources  # noqa: E402

ARCH = "kimi-k2-1t-a32b"
# (d, experts, top-k, expert ff, shared ff): the smoke shape, and another
SHAPES = [(64, 8, 2, 64, 64), (48, 12, 3, 40, 0)]


def _layer(shape, seed, bias: bool):
    """One MoE layer's float32 weights from the reference's init, its
    port copy, and a router bias (None, or nonzero)."""
    d, e, k, f, sf = shape
    p = j_moe.moe_init(jax.random.PRNGKey(seed), d, e, f, shared_f=sf,
                       dtype=jnp.float32)
    b = (np.random.default_rng(seed).normal(0, 0.05, e).astype(np.float32)
         if bias else None)
    return p, params_from_jax(jax.tree.map(np.asarray, p), device="cpu"), b


def _x(shape, seed, b=3, s=2):
    return np.random.default_rng(seed + 100).normal(
        0, 1, (b, s, shape[0])).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_router_topk_matches_reference(shape, bias):
    jp, tp, b = _layer(shape, 1, bias)
    x = _x(shape, 1)
    jg, ji, jpr = j_moe.router_topk(jp, jnp.asarray(x), shape[2],
                                    bias=None if b is None else jnp.asarray(b))
    tg, ti, tpr = t_moe.router_topk(tp, torch.from_numpy(x), shape[2], bias=_t(b))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), atol=1e-6, rtol=0)


@pytest.mark.parametrize("bias", [False, True])
def test_router_exact_tie_takes_the_lower_expert(bias):
    """Experts 2 and 5 (and 3 and 6) share a router column, so their scores
    tie exactly on every token: the lower expert id comes first."""
    shape = SHAPES[0]
    jp, _, b = _layer(shape, 2, bias)
    rng = np.random.default_rng(2)
    router = rng.normal(0, 0.01, (shape[0], shape[1])).astype(np.float32)
    router[:, 2], router[:, 3] = rng.normal(0, 1, (2, shape[0]))
    router[:, 5], router[:, 6] = router[:, 2], router[:, 3]
    if b is not None:
        b[5], b[6] = b[2], b[3]
    # tokens that rank the tied columns first
    x = np.tile(router[:, 2] + router[:, 3], (1, 4, 1)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for k in (1, 2, 3, 4):
        _, ji, _ = j_moe.router_topk(jp, jnp.asarray(x), k,
                                     bias=None if b is None else jnp.asarray(b))
        _, ti, _ = t_moe.router_topk(tp, torch.from_numpy(x), k, bias=_t(b))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert set(np.asarray(ji)[0, 0]) == {2, 3, 5, 6}


@pytest.mark.parametrize("n,bins", [(1, 4), (37, 5), (64, 8), (200, 13)])
def test_rank_in_bins_matches_reference(n, bins):
    eids = np.random.default_rng(n).integers(0, bins + 1, n).astype(np.int32)
    np.testing.assert_array_equal(
        t_moe._rank_in_bins(torch.from_numpy(eids), bins).numpy(),
        np.asarray(j_moe._rank_in_bins(jnp.asarray(eids), bins)))


def test_capacity_matches_reference():
    cases = [(t, k, e, cf) for t in (1, 2, 16, 512, 513, 4096, 70000)
             for k in (1, 2, 8) for e in (8, 384) for cf in (1.25, 2.0)]
    assert [t_moe._capacity(*c) for c in cases] == \
        [j_moe._capacity(*c) for c in cases]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_apply_ep_matches_reference(shape, bias):
    jp, tp, b = _layer(shape, 3, bias)
    x = _x(shape, 3)
    jy, ji, _ = j_moe.moe_apply_ep(jp, jnp.asarray(x), shape[2],
                                   bias=None if b is None else jnp.asarray(b))
    ty, ti, none = t_moe.moe_apply_ep(tp, torch.from_numpy(x), shape[2],
                                      bias=_t(b))
    assert none is None
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)


def _payload(p) -> np.ndarray:
    """(E, 3*d*f) [w_gate | w_in | w_out] rows, the engine's layout."""
    e = p["w_gate"].shape[0]
    return np.concatenate([np.asarray(p[k]).reshape(e, -1)
                           for k in ("w_gate", "w_in", "w_out")], axis=1)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_apply_tiered_matches_reference_and_the_dense_layer(shape, bias):
    """Group 1 of a two-group payload, half its experts promoted: the
    chosen experts are read from both tiers."""
    d, e, k, f, _ = shape
    jp, tp, b = _layer(shape, 4, bias)
    x = _x(shape, 4, b=4)
    rows = np.concatenate([_payload(_layer(shape, 9, False)[0]), _payload(jp)])
    hot = np.arange(e, 2 * e, 2)                        # group 1's even experts
    page_slot = np.full(2 * e, -1, np.int32)
    page_slot[hot] = np.arange(hot.size)
    fast = rows[hot]
    jb = None if b is None else jnp.asarray(b)
    jy, ji, _ = j_moe.moe_apply_tiered(
        jp, jnp.asarray(x), k, bias=jb, group_id=1,
        tier={"fast": jnp.asarray(fast), "slow": jnp.asarray(rows),
              "page_slot": jnp.asarray(page_slot)})
    ty, ti, _ = t_moe.moe_apply_tiered(
        tp, torch.from_numpy(x), k, bias=_t(b), group_id=1,
        tier={"fast": torch.from_numpy(fast), "slow": torch.from_numpy(rows),
              "page_slot": torch.from_numpy(page_slot), "scale": None})
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    hit = page_slot[e + ti.numpy()] >= 0
    assert hit.any() and not hit.all()
    dense, di, _ = t_moe.moe_apply_ep(tp, torch.from_numpy(x), k, bias=_t(b))
    assert torch.equal(di, ti)
    np.testing.assert_allclose(ty.numpy(), dense.numpy(), atol=1e-5, rtol=0)


def _resident(p, hot, fetch):
    """A layer's NeoMem-tiered serving params: the ``hot`` experts resident
    (in slot order), the ``fetch`` experts in the cold-fetch buffer."""
    e = p["router"].shape[-1]
    res = np.full(e, -1, np.int32)
    res[list(hot)] = np.arange(len(hot), dtype=np.int32)
    out = {k: v for k, v in p.items() if not k.startswith("w_")}
    for name, key in (("w_gate", "fetch_gate"), ("w_in", "fetch_in"),
                      ("w_out", "fetch_out")):
        out[name] = np.asarray(p[name])[list(hot)]
        out[key] = np.asarray(p[name])[list(fetch)]
    out["residency"] = res
    out["fetch_ids"] = np.asarray(fetch, np.int32)
    return out


@pytest.mark.parametrize("bias", [False, True])
def test_moe_apply_ep_refuses_expert_parallel_contexts(bias):
    """Once a refusal of the expert-parallel arms, now their parity on one
    device: the ``"residency"`` arm (three hot experts, two fetched, the
    rest served by the shared expert alone) against the reference's
    ``_ep_resident_body`` through its ``moe_apply_ep``."""
    shape = SHAPES[0]
    jp, _, b = _layer(shape, 5, bias)
    rp = _resident(jax.tree.map(np.asarray, jp), hot=(5, 1, 3), fetch=(0, 6))
    x = _x(shape, 5, b=4, s=3)
    jy, jidx, _ = j_moe.moe_apply_ep(jax.tree.map(jnp.asarray, rp), jnp.asarray(x),
                                     shape[2], bias=None if b is None else jnp.asarray(b))
    ty, tidx, _ = t_moe.moe_apply_ep(params_from_jax(rp, device="cpu"), _t(x),
                                     shape[2], bias=_t(b))
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    served = np.isin(np.asarray(jidx), (5, 1, 3, 0, 6))
    assert served.any() and not served.all()       # both kinds of assignment


def _expert_resources(cap):
    kw = dict(n_pages=16, hot_slots=4, stream_cap=cap)
    return (j_resources.ExpertStreamResource(
                j_resource.ResourceSpec("experts", **kw), n_experts=8),
            t_resources.ExpertStreamResource(
                t_resource.ResourceSpec("experts", **kw), n_experts=8))


@pytest.mark.parametrize("cap", [1 << 14, 7])
@pytest.mark.parametrize("shape", [(2, 1, 3, 1, 2), (5, 2, 1, 3, 1, 2)])
def test_expert_encode_stream_matches_reference(shape, cap):
    """A step's (G, n_moe, B, 1, k) stream and a prefill chunk's
    (C, G, n_moe, B, 1, k), with masked lanes' -1 pads, subsampled to a cap
    of 7 ids; the chunk's pages run past the resource's 16 (ROADMAP C4)."""
    router = np.random.default_rng(len(shape)).integers(0, 8, shape).astype(np.int32)
    router[..., 1, :, :] = -1                           # a masked lane
    jr, tr = _expert_resources(cap)
    want = np.asarray(jr.encode_stream(jnp.asarray(router)))
    got = tr.encode_stream(torch.from_numpy(router))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any()


def _tier_pair(resident):
    """The reference's and the port's tier state with ``resident`` pages
    (page -> slot) installed, 16 pages over 4 slots."""
    js = j_tiering.tier_init(j_tiering.TierParams(num_pages=16, num_slots=4,
                                                  quota_pages=4))
    for page, slot in resident.items():
        js = js._replace(page_slot=js.page_slot.at[page].set(slot),
                         slot_page=js.slot_page.at[slot].set(page))
    ts = t_tiering.TierState(*[torch.from_numpy(np.array(a)) for a in js])
    return js, ts


def _same_state(ts, js):
    for name, a, b in zip(js._fields, ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("resident", [{15: 2, 3: 0}, {3: 0}])
def test_tier_reads_and_writes_past_the_page_table_as_the_reference(resident):
    """Out-of-range page ids read the last page's entry (a JAX gather
    clamps) and their writes are dropped: touch, promote and the migration
    copy give the reference's state, events, rows and counts."""
    pages = np.array([100, 3, -1, 15, 40, 20], np.int32)
    js, ts = _tier_pair(resident)
    js = j_tiering.touch(js, jnp.asarray(pages))
    ts = t_tiering.touch(ts, torch.from_numpy(pages))
    _same_state(ts, js)
    hot = np.array([100, 20, 5, -1], np.int32)
    js2, jpro, jvic = j_tiering.promote(js, jnp.asarray(hot), 4)
    ts2, tpro, tvic = t_tiering.promote(ts, torch.from_numpy(hot), 4)
    _same_state(ts2, js2)
    np.testing.assert_array_equal(tpro.numpy(), np.asarray(jpro))
    np.testing.assert_array_equal(tvic.numpy(), np.asarray(jvic))
    # a slot that holds an out-of-range page is evicted by the next batch
    ev = np.asarray(js2.slot_page)[np.maximum(np.asarray(jvic), 0)]
    evicted = np.where(np.asarray(jvic) >= 0, ev, -1).astype(np.int32)
    evicted[0], jvic_ = 40, np.asarray(jvic).copy()
    jvic_[0], pro = 1, np.asarray(jpro).copy()
    pro[0] = 100
    rows = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    fast = np.full((4, 3), 7.0, np.float32)
    jb, jup, jdown = j_migrate.migrate(
        j_migrate.TierBuffers(jnp.asarray(fast), jnp.asarray(rows)),
        jnp.asarray(pro), jnp.asarray(jvic_), jnp.asarray(evicted))
    tb, tup, tdown = t_migrate.migrate(
        t_migrate.TierBuffers(torch.from_numpy(fast.copy()),
                              torch.from_numpy(rows.copy())),
        torch.from_numpy(pro), torch.from_numpy(jvic_), torch.from_numpy(evicted))
    assert (tup, tdown) == (jup, jdown)
    np.testing.assert_array_equal(tb.fast.numpy(), np.asarray(jb.fast))
    np.testing.assert_array_equal(tb.slow.numpy(), np.asarray(jb.slow))


def _read_all(fast, slow, slots, ids):
    """The read before the repair: every id's slow row, the fast copy kept
    where the page is resident."""
    slow_rows = slow[torch.where(ids >= 0, ids, 0)]
    hit = (slots >= 0).reshape(tuple(slots.shape) + (1,) * (fast.dim() - 1))
    return torch.where(hit, fast[torch.where(slots >= 0, slots, 0)], slow_rows)


@pytest.mark.parametrize("case", ["fast-only", "slow-only", "mixed"])
def test_read_rows_reads_only_the_misses(case, monkeypatch):
    rng = np.random.default_rng(7)
    slow = torch.from_numpy(rng.normal(size=(20, 3, 5)).astype(np.float32))
    page_slot = torch.full((20,), -1, dtype=torch.int32)
    resident = torch.tensor([2, 5, 11, 17])
    page_slot[resident] = torch.arange(4, dtype=torch.int32)
    fast = slow[resident].clone()
    ids = {"fast-only": [[2, 17, 5], [5, 2, 11]],
           "slow-only": [[0, 19, 4], [4, 7, -1]],
           "mixed": [[2, 3, 3], [17, -1, 9]]}[case]
    ids = torch.tensor(ids)
    read = []
    slow_rows = t_migrate._slow_rows

    def counting(store, scale, wanted, device, dtype):
        read.extend(np.asarray(wanted).tolist())
        return slow_rows(store, scale, wanted, device, dtype)
    monkeypatch.setattr(t_migrate, "_slow_rows", counting)
    got = t_migrate.lookup_rows(fast, slow, page_slot, ids)
    slots = torch.where(ids >= 0, page_slot[ids.clamp_min(0)], -1)
    assert torch.equal(got, _read_all(fast, slow, slots, ids))
    missed = sorted({max(int(i), 0) for i, s in zip(ids.reshape(-1), slots.reshape(-1))
                     if s < 0})
    assert read == missed
    assert (len(read) == 0) == (case == "fast-only")


# -- the paged MoE decode, float32 ------------------------------------------------

PAGE_T, SLOTS, B = 4, 4, 2


@pytest.fixture(scope="module")
def f32_params():
    jp = jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, j_tr.init_params(j_smoke(ARCH), jax.random.PRNGKey(0)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _rings(tc, jc):
    """Every ring of both caches, the prologue's included: integer leaves
    bitwise, pages within 1e-5."""
    pairs = list(zip(tc["blocks"], jc["blocks"])) + list(
        zip(tc["prologue"], jc["prologue"]))
    assert len(pairs) == 2
    for t_ring, j_ring in pairs:
        for key in ("page_len", "cur_slot"):
            np.testing.assert_array_equal(t_ring[key].numpy(), np.asarray(j_ring[key]))
        for key in ("k_pages", "v_pages"):
            np.testing.assert_allclose(t_ring[key].numpy(), np.asarray(j_ring[key]),
                                       atol=1e-5, rtol=0)


def test_decode_step_paged_moe_matches_reference(f32_params):
    """16 steps wrap the 4-slot ring of 4-token pages twice over."""
    jp, tp = f32_params
    cfg, tcfg = j_smoke(ARCH), t_registry.get_smoke_config(ARCH)
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg,
                                      page_t=PAGE_T, return_streams=True))
    jc = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T, dtype=jnp.float32)
    tc = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, dtype=torch.float32,
                                device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (16, B, 1))
    for step in range(16):
        jl, jc, js = jstep(jp, jc, jnp.asarray(toks[step]))
        tl, tc, ts = t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(toks[step]),
                                             page_t=PAGE_T, return_streams=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"logits step {step}")
        np.testing.assert_array_equal(ts["router"].numpy(), np.asarray(js["router"]),
                                      err_msg=f"router step {step}")
        np.testing.assert_allclose(ts["kv_mass"].numpy(), np.asarray(js["kv_mass"]),
                                   atol=1e-5, rtol=0, err_msg=f"mass step {step}")
    assert ts["router"].shape == (cfg.n_groups, 1, B, 1, cfg.moe.top_k)
    _rings(tc, jc)
    assert int(tc["pos"]) == int(jc["pos"]) == 16


def test_prefill_paged_moe_lane_chunk_matches_reference(f32_params):
    """A ragged chunk of one lane (lanes 0 and 2 frozen, a padding tail
    that is padding for every lane) after 5 steps of all three lanes: the
    last valid logits, the router ids of valid steps (the skipped columns'
    ids are -1) and every ring against the reference's scan with
    ``merge_cache``."""
    jp, tp = f32_params
    cfg, tcfg = j_smoke(ARCH), t_registry.get_smoke_config(ARCH)
    lanes, chunk, n = 3, 8, 5
    jc = j_dec.init_paged_cache(cfg, lanes, SLOTS, PAGE_T, dtype=jnp.float32,
                                per_lane_pos=True)
    tc = t_dec.init_paged_cache(tcfg, lanes, SLOTS, PAGE_T, dtype=torch.float32,
                                per_lane_pos=True, device="cpu")
    rng = np.random.default_rng(3)
    warm = rng.integers(0, cfg.vocab, (lanes, 5))
    _, jc, _ = j_dec.prefill_paged(cfg, jp, jc, jnp.asarray(warm), page_t=PAGE_T)
    _, tc, _ = t_dec.prefill_paged(tcfg, tp, tc, torch.from_numpy(warm),
                                   page_t=PAGE_T)
    tok = np.zeros((lanes, chunk), np.int64)
    tok[1, :n] = rng.integers(0, cfg.vocab, n)
    valid = np.zeros((lanes, chunk), bool)
    valid[1, :n] = True
    active = np.array([False, True, False])
    jl, jc, js = j_dec.prefill_paged(cfg, jp, jc, jnp.asarray(tok), page_t=PAGE_T,
                                     valid=jnp.asarray(valid),
                                     active=jnp.asarray(active), collect_mass=True)
    tl, tc, ts = t_dec.prefill_paged(tcfg, tp, tc, torch.from_numpy(tok),
                                     page_t=PAGE_T, valid=valid, active=active,
                                     collect_mass=True)
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], atol=1e-4, rtol=0)
    router = ts["router"].numpy()                         # (C, G, 1, L, 1, k)
    assert router.shape == (chunk, cfg.n_groups, 1, lanes, 1, cfg.moe.top_k)
    np.testing.assert_array_equal(router[:n, :, :, 1], np.asarray(js["router"])[:n, :, :, 1])
    assert (router[n:] == -1).all()
    np.testing.assert_allclose(ts["kv_mass"].numpy()[:n, :, :, 1],
                               np.asarray(js["kv_mass"])[:n, :, :, 1], atol=1e-5, rtol=0)
    _rings(tc, jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# -- configs, params and refusals -----------------------------------------------

def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_init_params_matches_reference_layout():
    """Same tree (the dense prologue, the router bias and the shared expert
    included), shapes and dtypes as the reference's init, and every
    reference leaf converts (``params_from_jax``) onto it."""
    cfg = j_smoke(ARCH)
    ref = jax.eval_shape(lambda: j_tr.init_params(cfg, jax.random.PRNGKey(0)))
    port = dict(_flatten(t_tr.init_params(t_registry.get_smoke_config(ARCH),
                                          seed=0, device="cpu")))
    conv = dict(_flatten(params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), ref), device="cpu")))
    assert set(port) == set(conv)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        key = jax.tree_util.keystr(path)
        for t in (port[key], conv[key]):
            assert tuple(t.shape) == leaf.shape, key
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    assert "['prologue'][0]['ffn']['w_gate']" in port
    assert port["['blocks'][0]['ffn']['router']"].dtype == torch.float32
    assert bool((port["['blocks'][0]['router_bias']"] == 0).all())


def test_large_tensors_draw_in_slices(monkeypatch):
    """Above the whole-draw size a tensor is filled slice by slice: the same
    numbers from the same seed, at the init scale."""
    monkeypatch.setattr(t_layers, "_WHOLE_DRAW", 1000)
    monkeypatch.setattr(t_layers, "_DRAW_SLICE", 300)
    draw = [t_layers._normal((7, 50, 40), 0.1, torch.Generator().manual_seed(3),
                             "cpu", torch.bfloat16) for _ in range(2)]
    assert torch.equal(*draw)
    assert abs(float(draw[0].float().std()) - 0.1) < 0.005


def test_configs_match_reference_and_other_archs_raise():
    for name in (ARCH,):
        assert dataclasses.asdict(t_registry.get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
        assert dataclasses.asdict(t_registry.get_smoke_config(name)) == \
            dataclasses.asdict(j_smoke(name))
    cfg = t_registry.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab,
            cfg.moe.n_experts, cfg.moe.top_k) == (61, 7168, 64, 8, 163840, 384, 8)
    # whisper serves (tests/test_torch_cross.py), but not with experts
    whisper = t_registry.get_config("whisper-base")
    t_tr.check_ported(whisper)
    # MLA and the multi-token head pass in the MoE family (deepseek-v3)
    t_tr.check_ported(dataclasses.replace(cfg, mtp=True))
    t_tr.check_ported(t_registry.get_smoke_config("deepseek-v3-671b"))
    dense = t_registry.get_smoke_config("llama3.2-3b")
    for bad in (dataclasses.replace(cfg, pattern=("attn", "moe")),
                dataclasses.replace(dense, mtp=True),
                dataclasses.replace(whisper, moe=cfg.moe)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_tr.check_ported(bad)
