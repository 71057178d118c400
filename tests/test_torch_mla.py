"""The port's MLA attention (deepseek-v3) against the reference, on the CPU,
from the reference's exact weights (``params_from_jax``).

* The plain attention (the CPU path of ``paged_attention_raw``) against the
  reference's Pallas kernel in interpret mode: (m, l, acc, page_m, page_l)
  within 1e-5 (float32, summation order only) at the smoke MLA shape (a
  group of 4, dk 24, dv 16) and at deepseek-v3's full head shape (a group
  of 128 over one latent head, dk 576, dv 512), masked pages, partial
  pages and a fully masked row included.
* The configs field for field, ``init_params``' tree (MLA and MTP leaves
  included) and every leaf converted bitwise; ``_rms``'s rounding.
* ``decode_step_paged`` on deepseek-v3-smoke, float32, 12 greedy steps
  across three 4-token pages (the dense prologue's ring included): logits
  within 1e-4, page mass within 1e-5, router ids, ``page_len``,
  ``cur_slot`` and the greedy ids bitwise, pages within 1e-5.
* ``prefill_paged`` bitwise equal to streaming the same tokens, and within
  the same tolerances of the reference's prefill.
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
from repro.kernels.paged_attn import ops as j_pa_ops  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attn import ops as t_pa_ops  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402

ARCH = "deepseek-v3-671b"
ATTN_TOL = 1e-5          # float32 attention stats: summation order only
LOGIT_TOL = 1e-4         # float32 logits through the whole smoke model


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the attention at the MLA shapes ---------------------------------------------

# (b, query heads, dk, dv, pages, page_t, d_nope + d_rope): one latent kv
# head serves every query head
MLA_SHAPES = [
    (2, 4, 24, 16, 3, 4, 24),        # deepseek-v3-smoke
    (1, 128, 576, 512, 2, 8, 192),   # deepseek-v3's head shape
    (2, 128, 576, 512, 3, 4, 192),
    (2, 128, 576, 512, 2, 8, 192),
]


def _mla_inputs(seed, b, h, dk, dv, p, t):
    """Queries of the latent width, one latent head of pages, and lengths
    with a full, a partial and a masked page; a masked row where b > 1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    kp = rng.normal(size=(b, p, t, 1, dk)).astype(np.float32)
    vp = rng.normal(size=(b, p, t, 1, dv)).astype(np.float32)
    lens = rng.integers(1, t + 1, (b, p)).astype(np.int32)
    lens[0, 0] = t
    lens[0, -1] = 0
    if b > 1 and p > 2:
        lens[1] = 0
    return q, kp, vp, lens


@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_plain_attention_matches_pallas_kernel_at_mla_shapes(shape):
    b, h, dk, dv, p, t, qk = shape
    q, kp, vp, lens = _mla_inputs(sum(shape), *shape[:6])
    scale = qk ** -0.5
    out_j = j_pa_ops.paged_attention_local_stats(
        *[jnp.asarray(x) for x in (q, kp, vp, lens)], scale=scale,
        interpret=True, return_page_stats=True)
    out_t = t_pa_ops.paged_attention_raw(_t(q), _t(kp), _t(vp), _t(lens),
                                         scale=scale, return_page_stats=True)
    assert out_t[2].shape == (b, h, dv)
    for name, a, r in zip(("m", "l", "acc", "page_m", "page_l"), out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=ATTN_TOL,
                                   atol=ATTN_TOL, err_msg=name)
    assert (out_t[3][0, -1] == -1e30).all() and (out_t[4][0, -1] == 0).all()
    mass = t_pa_ops.page_mass(out_t[0], out_t[1], out_t[3], out_t[4])
    live = lens.any(axis=1)
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[live], 1.0, atol=1e-5)


def test_head_tiled_kernel_is_chosen_above_the_group_limit():
    """Above MAX_GROUP the wrapper needs 16-byte K and V rows (the head-tiled
    kernel's TMA boxes) and dk <= MAX_TILED_DK (q's lo parts in registers),
    which MLA's 576 meets; the CPU path takes any shape."""
    assert 128 > t_pa_ops.MAX_GROUP and 4 <= t_pa_ops.MAX_GROUP
    kp = torch.zeros((1, 1, 4, 1, 576), dtype=torch.bfloat16)
    assert t_pa_ops._tma_rows(kp, 576) and t_pa_ops._tma_rows(kp[..., :512], 512)
    assert not t_pa_ops._tma_rows(kp, 36)
    assert t_pa_ops.head_tiled.__name__ == "paged_attention_head_tiled"
    assert t_pa_ops.MAX_TILED_DK == 576 == t_dec.ring_dims(
        t_registry.get_config(ARCH))[1]
    q = torch.zeros((1, 16, 640))
    kv = torch.zeros((1, 1, 4, 1, 640))
    out = t_pa_ops.paged_attention_raw(q, kv, kv, torch.full((1, 1), 4, dtype=torch.int32))
    assert out[2].shape == (1, 16, 640)         # the plain version: any dk


# -- configs, params, the MLA norm -----------------------------------------------------

def test_configs_match_reference():
    for get_t, get_j in ((t_registry.get_config, j_get_config),
                         (t_registry.get_smoke_config, j_smoke)):
        tc, jc = get_t(ARCH), get_j(ARCH)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.total_params() == jc.total_params()
        assert tc.active_params() == jc.active_params()
    cfg = t_registry.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.moe.n_experts,
            cfg.moe.n_dense_prologue, cfg.mla.kv_lora, cfg.mla.d_rope) == \
        (61, 7168, 128, 129280, 256, 3, 512, 64)
    assert t_dec.ring_dims(cfg) == (1, 576, 512)
    assert t_attn.MLA_DEFAULTS == j_attn.MLA_DEFAULTS == dataclasses.asdict(cfg.mla)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_init_params_tree_and_conversion_match_reference():
    """The port's init draws the reference's tree (MLA leaves in the body,
    the prologue and the MTP block; the MTP projection and norm), shapes
    and dtypes; the reference's weights convert onto it bitwise."""
    cfg = j_smoke(ARCH)
    ref = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    port = dict(_flatten(t_tr.init_params(t_registry.get_smoke_config(ARCH),
                                          seed=0, device="cpu")))
    conv = dict(_flatten(params_from_jax(jax.tree.map(np.asarray, ref),
                                         device="cpu")))
    assert set(port) == set(conv)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        key = jax.tree_util.keystr(path)
        for t in (port[key], conv[key]):
            assert tuple(t.shape) == leaf.shape, key
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
        np.testing.assert_array_equal(conv[key].float().numpy(),
                                      np.asarray(leaf, np.float32), err_msg=key)
    for key in ("['blocks'][0]['attn']['wkv_b']", "['prologue'][0]['attn']['wq_a']",
                "['mtp']['block']['attn']['kv_norm']", "['mtp']['proj']",
                "['mtp']['norm']['scale']", "['mtp']['block']['ffn']['w_gate']"):
        assert key in port, key
    m = cfg.mla
    assert port["['blocks'][0]['attn']['wkv_b']"].shape == (
        cfg.n_groups, m.kv_lora, cfg.n_heads * (m.d_nope + m.d_v))
    assert port["['mtp']['block']['ffn']['w_gate']"].shape == (cfg.d_model,
                                                                cfg.moe.dense_ff)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_matches_reference_and_keeps_the_input_dtype(dtype):
    x = np.random.default_rng(5).normal(size=(3, 2, 40)).astype(np.float32) * 3
    w = np.random.default_rng(6).normal(size=(40,)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    jy = j_attn._rms(jx, jnp.asarray(w))
    ty = t_attn._rms(tx, torch.from_numpy(w))
    assert ty.dtype == tx.dtype
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=ulp, atol=1e-6)


# -- paged decode and prefill, float32 ---------------------------------------------------

PAGE_T, SLOTS, B = 4, 4, 2


@pytest.fixture(scope="module")
def f32_params():
    jp = jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, j_tr.init_params(j_smoke(ARCH), jax.random.PRNGKey(0)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _rings(tc, jc):
    """Every ring of both caches, the prologue's included: integer leaves
    bitwise, pages within 1e-5, at the latent widths."""
    pairs = list(zip(tc["blocks"], jc["blocks"])) + list(
        zip(tc["prologue"], jc["prologue"]))
    assert len(pairs) == 2
    for t_ring, j_ring in pairs:
        assert t_ring["k_pages"].shape[-2:] == (1, 24)
        assert t_ring["v_pages"].shape[-2:] == (1, 16)
        for key in ("page_len", "cur_slot"):
            np.testing.assert_array_equal(t_ring[key].numpy(), np.asarray(j_ring[key]))
        for key in ("k_pages", "v_pages"):
            np.testing.assert_allclose(t_ring[key].numpy(), np.asarray(j_ring[key]),
                                       atol=1e-5, rtol=0)


def test_decode_step_paged_mla_matches_reference(f32_params):
    """12 greedy steps, each side on its own picks, over 3 pages."""
    jp, tp = f32_params
    cfg, tcfg = j_smoke(ARCH), t_registry.get_smoke_config(ARCH)
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg,
                                      page_t=PAGE_T, return_streams=True))
    jc = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T, dtype=jnp.float32)
    tc = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, dtype=torch.float32,
                                device="cpu")
    jtok = ttok = np.random.default_rng(0).integers(0, cfg.vocab, (B, 1))
    picks = []
    for step in range(12):
        jl, jc, js = jstep(jp, jc, jnp.asarray(jtok))
        tl, tc, ts = t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(ttok),
                                             page_t=PAGE_T, return_streams=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0, err_msg=f"logits step {step}")
        np.testing.assert_array_equal(ts["router"].numpy(), np.asarray(js["router"]),
                                      err_msg=f"router step {step}")
        np.testing.assert_allclose(ts["kv_mass"].numpy(), np.asarray(js["kv_mass"]),
                                   atol=ATTN_TOL, rtol=0, err_msg=f"mass step {step}")
        jtok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True).numpy()
        np.testing.assert_array_equal(ttok, jtok, err_msg=f"greedy step {step}")
        picks.append(ttok[:, 0])
    assert ts["router"].shape == (cfg.n_groups, 1, B, 1, cfg.moe.top_k)
    assert ts["kv_mass"].shape == (cfg.n_groups, 1, B, SLOTS)
    _rings(tc, jc)
    assert int(tc["pos"]) == int(jc["pos"]) == 12
    assert len({tuple(p) for p in picks}) > 1


def test_prefill_paged_mla_equals_streaming_and_reference(f32_params):
    """A 10-token prompt over 3 pages: the port's prefill is its streaming
    steps bitwise (logits, mass, router ids, every ring); against the
    reference's prefill the last logits within 1e-4 and the rings."""
    jp, tp = f32_params
    cfg, tcfg = j_smoke(ARCH), t_registry.get_smoke_config(ARCH)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, 10))

    def cache():
        return t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, dtype=torch.float32,
                                      device="cpu")
    tl, tc, ts = t_dec.prefill_paged(tcfg, tp, cache(), torch.from_numpy(toks),
                                     page_t=PAGE_T, collect_mass=True)
    sc, masses, routers = cache(), [], []
    for col in range(toks.shape[1]):
        sl, sc, ss = t_dec.decode_step_paged(
            tcfg, tp, sc, torch.from_numpy(toks[:, col:col + 1]), page_t=PAGE_T,
            return_streams=True)
        masses.append(ss["kv_mass"])
        routers.append(ss["router"])
    assert torch.equal(tl, sl[:, -1])
    assert torch.equal(ts["kv_mass"], torch.stack(masses))
    assert torch.equal(ts["router"], torch.stack(routers))
    for a, b in zip(tc["blocks"] + tc["prologue"], sc["blocks"] + sc["prologue"]):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    jc = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T, dtype=jnp.float32)
    jl, jc, js = j_dec.prefill_paged(cfg, jp, jc, jnp.asarray(toks), page_t=PAGE_T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(ts["router"].numpy(), np.asarray(js["router"]))
    _rings(tc, jc)
