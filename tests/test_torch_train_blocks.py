"""The training-only forms of the port's blocks against the reference, on the
CPU in float32, forward and gradients (``jax.vjp`` against autograd, one
seeded cotangent), from the reference's exact weights.

* ``mamba2_apply`` and ``mlstm_apply`` at chunks of 8 and 32 over 32
  positions (four chunks carry state across their borders; one does not),
  ``slstm_apply`` (log-depth scan against XLA's ``associative_scan``):
  outputs within 2e-5 of their max, every gradient within 1e-4 of its max +
  1e-6.  And as ``tests/test_ssm_parity.py`` holds the reference: each
  training form against the port's own recurrent decode rolled over the
  sequence (2e-2, the reference's bound there; float32 agrees far closer).
* ``mla_apply`` at the smoke MLA dims over 32 positions and over 1,024
  (the causal chunked path, two chunks of 512): output within 1e-5,
  gradients within 1e-4.
* ``moe_apply_dense``, ``moe_apply_gather`` (capacity 1.25 T k / E: tokens
  drop) and ``aux_load_balance_loss``: expert ids equal, outputs within
  1e-5, gradients within 1e-4; and ``moe_apply_ep`` under autograd at T k
  = 4,400 > 4,096, where the capacity is 2 T k / E and a router that sends
  every token to expert 0 drops half of its assignments.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro.models import mamba2 as j_m2  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import xlstm as j_xl  # noqa: E402
from repro_torch.ckpt.manager import tree_leaves  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import mamba2 as t_m2  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import xlstm as t_xl  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor tests slow down many-fold when each
    worker also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, S, D = 2, 32, 64
M2 = dict(headdim=16, d_state=16)


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _close(a, b, rel, abs_=0.0):
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    bound = rel * max(np.abs(a).max(), 1e-30) + abs_
    assert np.abs(a - b).max() <= bound, (np.abs(a - b).max(), bound)


def vjp_pair(j_fn, t_fn, jp, u, *, seed=9, n_out=1):
    """(reference out, port out, reference grads (params, u), port grads):
    the vjp of one seeded cotangent on the first ``n_out`` outputs (the
    reference's jitted)."""
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tu = torch.from_numpy(u).requires_grad_()
    leaves = [l.requires_grad_() for l in tree_leaves(tp)
              if l.is_floating_point()]
    ju = jnp.asarray(u)
    jout = jax.jit(j_fn)(jp, ju)
    tout = t_fn(tp, tu)
    single = not isinstance(jout, tuple)
    if single:
        jout, tout = (jout,), (tout,)
    ct = [np.random.default_rng(seed + i).normal(size=np.shape(o)).astype(np.float32)
          for i, o in enumerate(jout[:n_out])]

    def pull(p, x, cts):
        out, vjp = jax.vjp(j_fn, p, x)
        if single:
            return vjp(cts[0])
        rest = tuple(jnp.zeros_like(o) if jnp.issubdtype(o.dtype, jnp.floating)
                     else np.zeros(np.shape(o), jax.dtypes.float0)
                     for o in out[n_out:])
        return vjp(tuple(cts) + rest)

    jg_p, jg_u = jax.jit(pull)(jp, ju, [jnp.asarray(c) for c in ct])
    loss = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(tout, ct))
    tg = torch.autograd.grad(loss, leaves + [tu], allow_unused=True)
    jgl = [g for g in jax.tree_util.tree_leaves(jg_p)
           if jnp.issubdtype(g.dtype, jnp.floating)] + [jg_u]
    return jout, tout, jgl, tg


def _hold_grads(jgl, tg):
    assert len(jgl) == len(tg)
    for a, b in zip(jgl, tg):
        _close(a, torch.zeros(np.shape(a)) if b is None else b, 1e-4, 1e-6)


def _u(seed=1, s=S, d=D):
    return (np.random.default_rng(seed).normal(size=(B, s, d)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba2_apply_matches_reference(chunk):
    jp = _f32(j_m2.mamba2_init(jax.random.PRNGKey(0), D, expand=2, **M2))
    jo, to, jg, tg = vjp_pair(
        lambda p, x: j_m2.mamba2_apply(p, x, chunk=chunk, **M2),
        lambda p, x: t_m2.mamba2_apply(p, x, chunk=chunk, **M2), jp, _u())
    _close(jo[0], to[0], 2e-5)
    _hold_grads(jg, tg)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_apply_matches_reference(chunk):
    jp = _f32(j_xl.mlstm_init(jax.random.PRNGKey(2), D, n_heads=4))
    jo, to, jg, tg = vjp_pair(
        lambda p, x: j_xl.mlstm_apply(p, x, n_heads=4, chunk=chunk),
        lambda p, x: t_xl.mlstm_apply(p, x, n_heads=4, chunk=chunk), jp, _u(3))
    _close(jo[0], to[0], 2e-5)
    _hold_grads(jg, tg)


def test_slstm_apply_matches_reference():
    jp = _f32(j_xl.slstm_init(jax.random.PRNGKey(4), D))
    jo, to, jg, tg = vjp_pair(j_xl.slstm_apply, t_xl.slstm_apply, jp, _u(5))
    _close(jo[0], to[0], 2e-5)
    _hold_grads(jg, tg)


def _roll(decode, cache, u):
    outs = []
    for t in range(u.shape[1]):
        o, cache = decode(u[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_training_form_vs_own_recurrent_decode(kind):
    gen = torch.Generator().manual_seed(0)
    u = torch.from_numpy(_u(7))
    if kind == "mamba":
        p = t_m2.mamba2_init(gen, D, expand=2, device="cpu", dtype=torch.float32, **M2)
        par = t_m2.mamba2_apply(p, u, chunk=8, **M2)
        cache = t_m2.mamba2_init_cache(B, D, dtype=torch.float32, device="cpu", **M2)
        seq = _roll(lambda x, c: t_m2.mamba2_decode(p, x, c, **M2), cache, u)
    elif kind == "mlstm":
        p = t_xl.mlstm_init(gen, D, n_heads=4, device="cpu", dtype=torch.float32)
        par = t_xl.mlstm_apply(p, u, n_heads=4, chunk=8)
        cache = t_xl.mlstm_init_cache(B, D, 4, device="cpu")
        seq = _roll(lambda x, c: t_xl.mlstm_decode(p, x, c, n_heads=4), cache, u)
    else:
        p = t_xl.slstm_init(gen, D, device="cpu", dtype=torch.float32)
        par = t_xl.slstm_apply(p, u)
        cache = t_xl.slstm_init_cache(B, D, device="cpu")
        seq = _roll(lambda x, c: t_xl.slstm_decode(p, x, c), cache, u)
    np.testing.assert_allclose(par.numpy(), seq.numpy(), rtol=2e-2, atol=2e-2)
    assert np.abs(par.numpy() - seq.numpy()).max() <= 1e-4


MLA = dict(h=4, q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16)


@pytest.mark.parametrize("s", [32, 1024])
def test_mla_apply_matches_reference(s):
    jp = _f32(j_attn.mla_init(jax.random.PRNGKey(5), D, **MLA))
    jo, to, jg, tg = vjp_pair(
        lambda p, x: j_attn.mla_apply(p, x, rope_theta=10000.0, **MLA),
        lambda p, x: t_attn.mla_apply(p, x, rope_theta=10000.0, **MLA),
        jp, _u(6, s=s))
    _close(jo[0], to[0], 1e-5)
    _hold_grads(jg, tg)


E, K = 8, 2


def _moe_params(seed=7):
    return _f32(j_moe.moe_init(jax.random.PRNGKey(seed), D, E, 32, shared_f=32))


@pytest.mark.parametrize("which", ["dense", "gather"])
@pytest.mark.parametrize("bias", [False, True])
def test_moe_dispatch_matches_reference(which, bias):
    jp = _moe_params()
    b = np.linspace(-0.2, 0.2, E).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    j_fn = getattr(j_moe, f"moe_apply_{which}")
    t_fn = getattr(t_moe, f"moe_apply_{which}")
    jo, to, jg, tg = vjp_pair(lambda p, x: j_fn(p, x, K, bias=jb),
                              lambda p, x: t_fn(p, x, K, bias=tb), jp, _u(8),
                              n_out=1)
    np.testing.assert_array_equal(np.asarray(jo[1]), to[1].numpy())
    _close(jo[0], to[0], 1e-5)
    _close(jo[2], to[2], 1e-6)
    if which == "gather":      # capacity 20 of 64 tokens x 2: some drop
        counts = np.bincount(np.asarray(jo[1]).reshape(-1), minlength=E)
        assert counts.max() > int(1.25 * B * S * K / E)
    _hold_grads(jg, tg)
    assert float(j_moe.aux_load_balance_loss(jo[2], jo[1], E, K)) == pytest.approx(
        float(t_moe.aux_load_balance_loss(to[2], to[1], E, K)), rel=1e-6)


def test_aux_load_balance_loss_gradient():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(B, S, E)).astype(np.float32)
    idx = rng.integers(0, E, (B, S, K)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda l: j_moe.aux_load_balance_loss(
        jax.nn.softmax(l, -1), jnp.asarray(idx), E, K))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = t_moe.aux_load_balance_loss(torch.softmax(tl, -1), torch.from_numpy(idx), E, K)
    (tg,) = torch.autograd.grad(loss, [tl])
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    _close(jg, tg, 1e-5)


def test_moe_apply_ep_gradients_where_tokens_drop():
    """T k = 4,400: the capacity is 2 T k / E = 1,100, and a router column
    that every token prefers sends all 2,200 tokens to expert 0."""
    jp = _moe_params(9)
    router = np.asarray(jp["router"]).copy()
    router[:, 0] += 0.5
    jp = dict(jp, router=jnp.asarray(router))
    u = (np.random.default_rng(10).normal(size=(B, 1100, D)) * 0.5 + 1.0
         ).astype(np.float32)
    jo, to, jg, tg = vjp_pair(lambda p, x: j_moe.moe_apply_ep(p, x, K)[:2],
                              lambda p, x: t_moe.moe_apply_ep(p, x, K)[:2],
                              jp, u, n_out=1)
    ids = np.asarray(jo[1])
    np.testing.assert_array_equal(ids, to[1].numpy())
    assert (ids[..., 0] == 0).all()                # expert 0 over its capacity
    assert t_moe._capacity(B * 1100, K, E, 2.0) == 1100
    _close(jo[0], to[0], 1e-5)
    _hold_grads(jg, tg)
