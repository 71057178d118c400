"""The port's optimizers and gradient codecs against the reference, on the
CPU, from equal params and gradients (numpy, from a seed).

* ``schedule`` at steps 1..40 of a 2-step warmup and 24-step cosine, and
  ``clip_by_global_norm``: float32 within 1 ulp-scale (2e-7 relative); the
  reference runs eagerly, as its source divides (its jitted step compiles a
  division by a constant as a product by the reciprocal).
* AdamW and Adafactor over 3 steps, the clip biting: every param and every
  moment within 1e-6 relative of its max (the global norm sums in another
  order), ``step`` equal.
* ``zero1_update`` with and without ``compress_collective`` over 3 steps,
  the clip not biting (norm < ``grad_clip``, so the scale is exactly 1):
  m, v, ``step``, ``ef`` and the params bitwise, the flat layout the
  reference's ``flat_spec`` (sizes, shapes, padding; m's slice of each leaf
  where the reference's is), the int8 payload and scale of
  ``compress_delta`` bitwise, and ``collective_bytes`` equal; with the clip
  biting, m and v within 1e-6 relative.
* ``compress_grads`` / ``decompress_grads`` with their residuals over 3
  rounds, float32 and bf16 gradients: payloads, scales, residuals and the
  decompressed gradients bitwise; ``psum_bytes`` / ``compressed_bytes``
  equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist import compression as j_comp  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.optim import zero1 as j_z1  # noqa: E402
from repro_torch.ckpt.manager import tree_leaves  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.dist import compression as t_comp  # noqa: E402
from repro_torch.optim import optimizers as t_opt  # noqa: E402
from repro_torch.optim import zero1 as t_z1  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor tests slow down many-fold when each
    worker also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"w": (12, 20), "b": (20,), "blocks": [{"k": (3, 8, 4), "s": (3, 1, 6)}],
          "emb": (16, 1)}


def _tree(rng, scale=1.0, dtype=np.float32):
    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        return (rng.normal(size=node) * scale).astype(dtype)
    return draw(SHAPES)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_jax(tree, device="cpu")


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _close(a, b, rel):
    a, b = np.asarray(a, np.float32), _np(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-30), \
        (np.abs(a - b).max(), np.abs(a).max())


def _leaves_close(jt, tt, rel):
    jl, tl = jax.tree_util.tree_leaves(jt), tree_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(a, b, rel)


def test_schedule_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=24)
    for s in range(1, 41):
        want = np.asarray(j_opt.schedule(j_opt.OptConfig(**cfg),
                                         jnp.asarray(s, jnp.int32)))
        got = t_opt.schedule(t_opt.OptConfig(**cfg),
                             torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(want) - float(got)) <= 2e-7 * abs(float(want)), s


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    g = _tree(rng)
    jc, jn = j_opt.clip_by_global_norm(_j(g), max_norm)
    tc, tn = t_opt.clip_by_global_norm(tree_leaves(_t(g)), max_norm)
    assert abs(float(jn) - float(tn)) <= 2e-7 * float(jn)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tc):
        _close(a, b, 2e-7)
    if max_norm > float(jn):          # scale exactly 1: the leaves unchanged
        for a, b in zip(jax.tree_util.tree_leaves(jc), tc):
            np.testing.assert_array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_three_steps_match_reference(kind, dtype):
    rng = np.random.default_rng(1)
    npd = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    p0 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, npd)), _tree(rng))
    cfg = dict(kind=kind, lr=1e-2, warmup_steps=1, total_steps=6)
    j_init, j_upd = j_opt.make_optimizer(j_opt.OptConfig(**cfg))
    t_init, t_upd = t_opt.make_optimizer(t_opt.OptConfig(**cfg))
    jp, tp = _j(p0), _t(p0)
    js, ts = j_init(jp), t_init(tp)
    for _ in range(3):
        g = _tree(rng, scale=2.0)          # norm > grad_clip: the clip bites
        jp, js, jm = j_upd(jp, _j(g), js)
        tp, ts, tm = t_upd(tp, _t(g), ts)
        assert abs(float(jm["gnorm"]) - float(tm["gnorm"])) <= 2e-7 * float(jm["gnorm"])
        assert abs(float(jm["lr"]) - float(tm["lr"])) <= 2e-7 * float(jm["lr"])
    assert int(js["step"]) == int(ts["step"]) == 3
    # bf16 params round once an update: a 1-ulp difference of the float32
    # update can flip that rounding
    _leaves_close(jp, tp, 1e-6 if dtype == "float32" else 2 ** -7)
    if kind == "adamw":
        _leaves_close(js["m"], ts["m"], 1e-6)
        _leaves_close(js["v"], ts["v"], 1e-6)
    else:
        jl = jax.tree_util.tree_leaves(js["s"])
        tl = tree_leaves(ts["s"])
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            _close(a, b, 1e-6)


def test_flat_spec_layout_is_the_reference():
    rng = np.random.default_rng(2)
    p = _tree(rng)
    js = j_z1.flat_spec(_j(p), 1)
    ts = t_z1.flat_spec(_t(p), 1)
    assert ts.sizes == js.sizes and ts.padded == js.padded
    assert ts.shapes == [tuple(s) for s in js.shapes]
    np.testing.assert_array_equal(np.asarray(j_z1.flatten(_j(p), js)),
                                  t_z1.flatten(_t(p), ts).numpy())
    back = t_z1.unflatten(t_z1.flatten(_t(p), ts), ts)
    for a, b in zip(jax.tree_util.tree_leaves(_j(p)), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("compress", [False, True])
def test_zero1_update_bitwise(compress):
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=6)
    jcfg, tcfg = j_z1.OptConfig(**cfg), t_opt.OptConfig(**cfg)
    jp, tp = _j(p0), _t(p0)
    jst, jspec = j_z1.zero1_init(jp, None, compress_collective=compress)
    tst, tspec = t_z1.zero1_init(tp, None, compress_collective=compress)
    for _ in range(3):
        g = _tree(rng, scale=0.02)         # norm < grad_clip: scale exactly 1
        jp, jst, jm = j_z1.zero1_update(jcfg, jp, _j(g), jst, jspec, None,
                                        compress_collective=compress)
        tp, tst, tm = t_z1.zero1_update(tcfg, tp, _t(g), tst, tspec, None,
                                        compress_collective=compress)
        assert float(jm["gnorm"]) < 1.0
        assert jm["collective_bytes"] == tm["collective_bytes"]
    for k in jst:
        np.testing.assert_array_equal(np.asarray(jst[k]), tst[k].numpy(), err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if compress:
        assert tm["collective_bytes"] == tspec.padded + 4
        # the int8 payload of one more delta, bitwise
        delta = rng.normal(size=(tspec.padded,)).astype(np.float32) * 1e-3
        ja, je, jw = j_z1.compress_delta(jnp.asarray(delta), jst["ef"], 1)
        ta, te, tw = t_z1.compress_delta(torch.from_numpy(delta), tst["ef"], 1)
        jq, jsc = j_z1.quantize_int8(jnp.asarray(delta) + jst["ef"], axes=(0,))
        tq, tsc = t_z1.quantize_int8(torch.from_numpy(delta) + tst["ef"], axes=(0,))
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
        np.testing.assert_array_equal(np.asarray(jsc), tsc.numpy())
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(je), te.numpy())
        assert jw == tw
    else:
        assert tm["collective_bytes"] == 4 * tspec.padded


def test_zero1_moments_with_the_clip_biting():
    rng = np.random.default_rng(4)
    p0 = _tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=6)
    jp, tp = _j(p0), _t(p0)
    jst, jspec = j_z1.zero1_init(jp, None, compress_collective=True)
    tst, tspec = t_z1.zero1_init(tp, None, compress_collective=True)
    for _ in range(3):
        g = _tree(rng, scale=2.0)
        jp, jst, _ = j_z1.zero1_update(j_z1.OptConfig(**cfg), jp, _j(g), jst,
                                       jspec, None, compress_collective=True)
        tp, tst, _ = t_z1.zero1_update(t_opt.OptConfig(**cfg), tp, _t(g), tst,
                                       tspec, None, compress_collective=True)
    _close(jst["m"], tst["m"], 1e-6)
    _close(jst["v"], tst["v"], 1e-6)
    assert int(tst["step"]) == 3


def test_zero1_toggle_off_threads_ef_through():
    p = {"w": torch.ones((8, 8))}
    st, spec = t_z1.zero1_init(p, None, compress_collective=True)
    st["ef"] += 0.25
    g = {"w": torch.full((8, 8), 0.1)}
    _, st2, _ = t_z1.zero1_update(t_opt.OptConfig(warmup_steps=0), p, g, st,
                                  spec, None, compress_collective=False)
    assert st2["ef"] is st["ef"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_with_residuals_bitwise(dtype):
    rng = np.random.default_rng(5)
    npd = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    cast = lambda t: jax.tree.map(lambda a: np.asarray(jnp.asarray(a, npd)), t)
    zeros = _tree(rng, 0.0)
    jef, tef = j_comp.ef_init(_j(zeros)), t_comp.ef_init(_t(zeros))
    for _ in range(3):
        g = cast(_tree(rng))
        jq, jef = j_comp.compress_grads(_j(g), jef)
        tq, tef = t_comp.compress_grads(_t(g), tef)
        jd, td = j_comp.decompress_grads(jq), t_comp.decompress_grads(tq)
        for a, b in zip(jax.tree_util.tree_leaves(jd), tree_leaves(td)):
            assert b.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
            np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))
        for a, b in zip(jax.tree_util.tree_leaves(jef), tree_leaves(tef)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        jp = [x for x in jax.tree_util.tree_leaves(jq) if x.size]
        tp = [x for x in tree_leaves(tq) if x.numel()]
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert t_comp.compressed_bytes(tq) == j_comp.compressed_bytes(jq)
    for c in (False, True):
        assert t_comp.psum_bytes(_t(g), c) == j_comp.psum_bytes(_j(g), c)
