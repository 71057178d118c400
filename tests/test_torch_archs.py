"""The port's layer features and its ten archs against the reference, on the
CPU at smoke widths, from the reference's exact weights (``params_from_jax``).

* Configs: qwen1.5-4b, stablelm-1.6b, gemma2-27b, zamba2-2.7b, xlstm-1.3b,
  llama-3.2-vision-11b and whisper-base, ``CONFIG`` and ``SMOKE_CONFIG``
  equal field for field; the registry (all ten archs, none unported).
* Norms (``rms``, ``rms+1``, ``ln``) and MLPs (swiglu, geglu, gelu): float32
  within 1e-6 (summation order only); bf16 within one bf16 ulp of the
  output's scale (2^-7 relative: each side rounds the float32 result once,
  and the port's GELU and SiLU round once where XLA's may not, ROADMAP C2).
* The params tree (names, shapes, dtypes) of the dense archs and of the
  vision and encoder-decoder archs (cross weights, gates, the encoder).
* ``decode_step`` (the full cache, no aux embeddings: the cross blocks run
  as self-attention blocks) and ``decode_step_paged`` (the ring; not
  whisper's, as in the reference) of every arch, float32 params and
  caches, 12 teacher-forced steps:
  logits within 1e-4, page mass within 1e-5 (none on xlstm, which has no
  attention), router ids bitwise, cache positions exact, K/V rows within
  1e-5, zamba2's and xlstm's recurrent states within 1e-5 of their scale.
* ``check_ported`` still raises for a family's block kinds outside it: the
  recurrent, shared-attention, cross and decoder kinds and an encoder in
  the dense family.

Cross attention over aux embeddings, the encoder and the two archs'
serving are ``tests/test_torch_cross.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402

NEW_ARCHS = ("qwen1.5-4b", "stablelm-1.6b", "gemma2-27b")
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-base")
ARCHS = ("llama3.2-3b", "kimi-k2-1t-a32b", "deepseek-v3-671b") + NEW_ARCHS \
    + ("zamba2-2.7b", "xlstm-1.3b") + CROSS_ARCHS
# the ring's archs: all but whisper, whose paged decode the reference skips
PAGED_ARCHS = tuple(a for a in ARCHS if a != "whisper-base")
STEPS, B = 12, 2
PAGE_T, SLOTS = 4, 4        # a 16-token ring: 12 steps fill three pages


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# the recurrent blocks' state leaves (Mamba2's, m/sLSTM's)
STATE_KEYS = {"ssm", "conv", "c", "n", "m"}


def state_tol(w):
    """1e-5 of a float32 recurrent state's scale: its largest magnitude, at
    least 1 (xlstm's normaliser ``n`` grows past 5), the stabiliser's -1e30
    left out (both sides hold it exactly until a lane's first step)."""
    finite = np.abs(w[np.abs(w) < 1e29])
    return 1e-5 * max(1.0, float(finite.max()) if finite.size else 1.0)


def _close_leaves(got_cache, want_cache, arch):
    """Every block cache leaf: K/V rows within 1e-5, recurrent states
    within :func:`state_tol`, integer leaves exact."""
    for got, want in zip(got_cache["blocks"], want_cache["blocks"]):
        for k in want:
            w = np.asarray(want[k])
            if w.dtype.kind != "f":
                np.testing.assert_array_equal(_np(got[k]), w, err_msg=f"{arch} {k}")
                continue
            np.testing.assert_allclose(
                _np(got[k]), w.astype(np.float32), rtol=0,
                atol=state_tol(w) if k in STATE_KEYS else 1e-5,
                err_msg=f"{arch} cache {k}")


@pytest.fixture(scope="module")
def f32_params():
    """Every arch's smoke params from the reference's init (seed 0), float32,
    as (reference tree, port tree)."""
    out = {}
    for arch in ARCHS:
        jp = _f32(j_tr.init_params(j_smoke(arch), jax.random.PRNGKey(0)))
        out[arch] = jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS + ("zamba2-2.7b", "xlstm-1.3b")
                         + CROSS_ARCHS)
def test_configs_match_reference(arch):
    for full in (True, False):
        get_t = t_registry.get_config if full else t_registry.get_smoke_config
        get_j = j_get_config if full else j_smoke
        assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


def test_registry_lists_the_six_ported_archs():
    """Every arch of the reference's registry is ported: ten, none left."""
    assert t_registry.list_archs() == list(ARCHS)
    assert len(ARCHS) == 10 and t_registry.NOT_YET_PORTED == ()
    from repro.configs.registry import ARCHS as j_archs
    assert set(ARCHS) == set(j_archs)
    for name in ARCHS:
        t_tr.check_ported(t_registry.get_config(name))
        t_tr.check_ported(t_registry.get_smoke_config(name))


def _close_bf16(got, want):
    """Within one bf16 ulp of the output's scale (see the module docstring)."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=scale * 2 ** -7, rtol=0)


@pytest.mark.parametrize("kind", ["rms", "rms+1", "ln"])
def test_norms_match_reference(kind):
    d = 48
    init = j_layers.make_norm(kind, d)
    port_init = t_layers.make_norm(kind, (d,), "cpu")
    assert set(port_init) == set(init)
    for k, v in init.items():
        np.testing.assert_array_equal(port_init[k].numpy(), np.asarray(v))
        assert port_init[k].dtype == torch.float32
    rng = np.random.default_rng(0)
    p = {k: (np.asarray(v) + rng.normal(0, 0.3, d)).astype(np.float32)
         for k, v in init.items()}
    x = (rng.normal(0.5, 2.0, (3, 5, d))).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(j_layers.apply_norm(kind, p, jnp.asarray(x)))
    got = t_layers.apply_norm(kind, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want = np.asarray(j_layers.apply_norm(kind, p, jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got = t_layers.apply_norm(kind, tp, torch.from_numpy(x).bfloat16()).float().numpy()
    _close_bf16(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(kind):
    d, f = 32, 80
    p = j_layers.mlp_init(jax.random.PRNGKey(3), d, f, kind, dtype=jnp.float32)
    if kind == "gelu":     # nonzero biases, so that both are exercised
        rng = np.random.default_rng(1)
        p["b_in"] = jnp.asarray(rng.normal(0, 0.1, f), jnp.float32)
        p["b_out"] = jnp.asarray(rng.normal(0, 0.1, d), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(2).normal(0, 1.5, (2, 3, d)).astype(np.float32)
    want = np.asarray(j_layers.mlp_apply(p, jnp.asarray(x), kind))
    got = t_layers.mlp_apply(tp, torch.from_numpy(x), kind).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    tb = params_from_jax(jax.tree.map(np.asarray, pb), device="cpu")
    want = np.asarray(j_layers.mlp_apply(pb, jnp.asarray(x, jnp.bfloat16), kind)
                      .astype(jnp.float32))
    got = t_layers.mlp_apply(tb, torch.from_numpy(x).bfloat16(), kind).float().numpy()
    np.testing.assert_allclose(got, want, atol=float(np.abs(want).max()) * 2 ** -6,
                               rtol=0)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_init_matches_reference_tree(kind):
    """``mlp_init``: the reference's keys, shapes and dtypes (bf16 by
    default, float32 when asked), zero biases, each matrix's std within 5%
    of the reference's scale (d^-1/2 into the hidden width, f^-1/2 out of
    it) and of the reference's own draw; ``lead`` stacks layers in front.
    The draws themselves differ (a ``torch.Generator``, not ``jax.random``)."""
    d, f = 64, 256
    for j_dtype, t_dtype in ((jnp.bfloat16, None), (jnp.float32, torch.float32)):
        ref = j_layers.mlp_init(jax.random.PRNGKey(0), d, f, kind, dtype=j_dtype)
        kw = {} if t_dtype is None else {"dtype": t_dtype}
        gen = torch.Generator().manual_seed(0)
        port = t_layers.mlp_init(gen, d, f, kind, device="cpu", **kw)
        assert set(port) == set(ref)
        for name, leaf in ref.items():
            t = port[name]
            assert tuple(t.shape) == leaf.shape, name
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
            if name.startswith("b_"):
                assert bool((t == 0).all()), name
                continue
            scale = (d if name != "w_out" else f) ** -0.5
            std = float(t.float().std())
            assert abs(std - scale) < 0.05 * scale, (name, std, scale)
            ref_std = float(np.asarray(leaf, np.float32).std())
            assert abs(std - ref_std) < 0.05 * ref_std, (name, std, ref_std)
    stacked = t_layers.mlp_init(torch.Generator().manual_seed(0), d, f, kind,
                                lead=(3,), device="cpu")
    assert {k: tuple(v.shape) for k, v in stacked.items()} == \
        {k: (3,) + tuple(v.shape) for k, v in port.items()}


def test_embed_init_matches_reference_tree():
    """``embed_init``: the reference's ``table`` (v, d), bf16 by default,
    std within 5% of d^-1/2 and of the reference's own draw."""
    v, d = 512, 64
    ref = j_layers.embed_init(jax.random.PRNGKey(0), v, d)
    port = t_layers.embed_init(torch.Generator().manual_seed(0), v, d, device="cpu")
    assert set(port) == set(ref) == {"table"}
    t = port["table"]
    assert tuple(t.shape) == ref["table"].shape
    assert str(t.dtype).split(".")[-1] == str(ref["table"].dtype)
    std = float(t.float().std())
    assert abs(std - d ** -0.5) < 0.05 * d ** -0.5, std
    ref_std = float(np.asarray(ref["table"], np.float32).std())
    assert abs(std - ref_std) < 0.05 * ref_std, (std, ref_std)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", NEW_ARCHS + CROSS_ARCHS)
def test_init_params_matches_reference_layout(arch):
    """Same tree, shapes and dtypes as the reference's init; norm inits as
    the reference's (``rms+1`` scales at 0, ``ln`` biases at 0), QKV biases
    and post-norms where the arch has them."""
    cfg = j_smoke(arch)
    ref = jax.eval_shape(lambda: j_tr.init_params(cfg, jax.random.PRNGKey(0)))
    port = t_tr.init_params(t_registry.get_smoke_config(arch), seed=0, device="cpu")
    port_flat = dict(_flatten(port))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert set(port_flat) == {jax.tree_util.keystr(p) for p, _ in ref_leaves}
    for path, leaf in ref_leaves:
        key = jax.tree_util.keystr(path)
        assert tuple(port_flat[key].shape) == leaf.shape, key
        assert str(port_flat[key].dtype).split(".")[-1] == str(leaf.dtype), key
    blk = port["blocks"][0]
    assert ("bq" in blk["attn"]) == cfg.qkv_bias
    assert ("pn1" in blk) == cfg.post_norm
    want = 0.0 if cfg.norm == "rms+1" else 1.0
    assert bool((port["final_norm"]["scale"] == want).all())
    if cfg.norm == "ln":
        assert bool((blk["ln1"]["bias"] == 0).all())


def _teacher_tokens(vocab):
    return np.random.default_rng(7).integers(0, vocab, (STEPS, B, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, f32_params):
    """The full-cache decode, max_seq 16 (past gemma2-smoke's window of 8)."""
    jp, tp = f32_params[arch]
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jc = j_dec.init_cache(cfg, B, 16, dtype=jnp.float32)
    tc = t_dec.init_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, c, t: j_dec.decode_step(cfg, p, c, t,
                                                     return_streams=True))
    for i, tok in enumerate(_teacher_tokens(cfg.vocab)):
        jl, jc, js = step(jp, jc, jnp.asarray(tok))
        tl, tc, ts = t_dec.decode_step(tcfg, tp, tc, torch.from_numpy(tok),
                                       return_streams=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"{arch} logits step {i}")
        if js["router"] is None:
            assert ts["router"] is None
        else:
            np.testing.assert_array_equal(ts["router"].numpy(), np.asarray(js["router"]))
    assert int(tc["pos"]) == int(jc["pos"]) == STEPS
    _close_leaves(tc, jc, arch)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_decode_step_paged_matches_reference(arch, f32_params):
    """The ring, with gemma2's embedding scale and post-norms (its paged
    path reads no window, as the reference's, ROADMAP C5)."""
    jp, tp = f32_params[arch]
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jc = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T, dtype=jnp.float32)
    tc = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, dtype=torch.float32,
                                device="cpu")
    step = jax.jit(lambda p, c, t: j_dec.decode_step_paged(
        cfg, p, c, t, page_t=PAGE_T, return_streams=True))
    for i, tok in enumerate(_teacher_tokens(cfg.vocab)):
        jl, jc, js = step(jp, jc, jnp.asarray(tok))
        tl, tc, ts = t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(tok),
                                             page_t=PAGE_T, return_streams=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"{arch} logits step {i}")
        if js["kv_mass"] is None:                # no attention (xlstm)
            assert ts["kv_mass"] is None
        else:
            np.testing.assert_allclose(ts["kv_mass"].numpy(),
                                       np.asarray(js["kv_mass"]), atol=1e-5,
                                       rtol=0, err_msg=f"{arch} mass step {i}")
        if js["router"] is not None:
            np.testing.assert_array_equal(ts["router"].numpy(), np.asarray(js["router"]))
    _close_leaves(tc, jc, arch)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm", "shared_attn",
                                  "cross", "dec", "encoder_layers"])
def test_check_ported_still_refuses_unported_kinds(kind):
    """Each block kind runs only in its own family, not mixed into a dense
    arch: the recurrent and shared-attention kinds in the hybrid and ssm
    families (``tests/test_torch_ssm.py``), ``cross`` in the vision family,
    ``dec`` and an encoder in the encoder-decoder family
    (``tests/test_torch_cross.py``)."""
    cfg = t_registry.get_smoke_config("llama3.2-3b")
    bad = (dataclasses.replace(cfg, encoder_layers=2, n_layers=6)
           if kind == "encoder_layers"
           else dataclasses.replace(cfg, pattern=("attn", kind)))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_tr.check_ported(bad)
    # the dense family's own kinds and layer features pass
    t_tr.check_ported(dataclasses.replace(
        cfg, pattern=("attn_local", "attn_global"), norm="ln", mlp="gelu",
        qkv_bias=True, post_norm=True, embed_scale=True))
