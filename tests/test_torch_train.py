"""The port's training forward and loss (``transformer.forward`` /
``train_loss``) against the reference, on the CPU, at every arch's smoke
config, B 2, S 32, from the reference's exact weights with every ``cross``
block's gate at ``GATE`` (the reference draws it as zero; then an image
changes nothing).

* float32 (every floating leaf cast in both trees): the loss within 1e-5
  relative and every gradient leaf within 1e-4 * max|g_ref| + 1e-6, the
  reference's ``jax.value_and_grad`` (jitted, remat on) against autograd;
  for the MoE archs the router streams (G, n_moe, B, S, k) equal.

The bf16 cases, ``remat`` off and the loss mask are in
``test_torch_train_bf16.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.ckpt.manager import tree_leaves  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor tests slow down many-fold when each
    worker also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, S = 2, 32
GATE = 0.5


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def gated(params, gate=GATE):
    """The reference's params with every ``cross`` block's gate at ``gate``."""
    return dict(params, blocks=[
        dict(b, xgate=jnp.full_like(b["xgate"], gate)) if "xgate" in b else b
        for b in params["blocks"]])


def smoke_batch(cfg, seed=0, mask=False):
    """A numpy batch: tokens, next-token-unrelated labels, aux embeddings
    where the arch takes them, and optionally a loss mask."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_aux_tokens:
        batch["aux_embeds"] = rng.normal(
            0, 1, (B, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def run_both(arch, f32=True, mask=False, remat=True):
    """(reference (loss, grads, aux), port (loss, grads, aux), port params)."""
    cfg = j_smoke(arch)
    jp = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    jp = gated(_f32(jp) if f32 else jp)
    batch = smoke_batch(cfg, mask=mask)
    jb = jax.tree.map(jnp.asarray, batch)
    if not f32 and "aux_embeds" in jb:
        jb["aux_embeds"] = jb["aux_embeds"].astype(jnp.bfloat16)
    (jl, (_, jaux)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_tr.train_loss(cfg, p, b, remat=True), has_aux=True))(jp, jb)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = [l.requires_grad_() for l in tree_leaves(tp)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if not f32 and "aux_embeds" in tb:
        tb["aux_embeds"] = tb["aux_embeds"].to(torch.bfloat16)
    tl, (_, taux) = t_tr.train_loss(get_smoke_config(arch), tp, tb, remat=remat)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    tg = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, tg)]
    return (jl, jax.tree_util.tree_leaves(jg), jaux), (tl.detach(), tg, taux), tp


def _hold(j, t, loss_rel, grad_rel):
    jl, jg, _ = j
    tl, tg, _ = t
    assert abs(float(jl) - float(tl)) <= loss_rel * abs(float(jl)), (float(jl), float(tl))
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        a = np.asarray(a, np.float32)
        assert a.shape == tuple(b.shape)
        bound = grad_rel * np.abs(a).max() + 1e-6
        assert np.abs(a - _np(b)).max() <= bound, (np.abs(a - _np(b)).max(), bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_float32(arch):
    j, t, _ = run_both(arch)
    _hold(j, t, 1e-5, 1e-4)
    if "router_streams" in j[2]:
        rs = t[2]["router_streams"]
        cfg = get_smoke_config(arch)
        assert tuple(rs.shape) == (cfg.n_groups, 1, B, S, cfg.moe.top_k)
        assert rs.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j[2]["router_streams"]), rs.numpy())
    else:
        assert "router_streams" not in t[2]
