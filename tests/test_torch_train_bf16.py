"""The port's training loss at the reference's dtype, without remat and with
a loss mask, against the reference on the CPU (``test_torch_train.py``'s
helpers; smoke configs, B 2, S 32, the reference's exact weights).

* bf16, the reference's dtype, llama3.2-3b and kimi-k2: the loss within
  2e-3 relative and each gradient leaf within 0.05 * max|g_ref| + 1e-6.
  XLA keeps bf16 intermediates of a fusion in float32 (ROADMAP C2) and
  both sides sum in other orders, so this bound is loose by design; the
  float32 cases of ``test_torch_train.py`` are the tight ones.
* float32 with a ``loss_mask``: the reference's bounds there, and with
  ``remat`` off the port's loss and gradients bitwise its own with it on.
* ``forward``'s hidden states and router streams on deepseek-v3 (the dense
  prologue layer and the MTP block add no stream).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.ckpt.manager import tree_leaves  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from test_torch_train import B, S, _f32, _hold, run_both, smoke_batch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor tests slow down many-fold when each
    worker also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "kimi-k2-1t-a32b"])
def test_train_loss_and_grads_bf16(arch):
    j, t, _ = run_both(arch, f32=False)
    assert all(g.dtype == torch.bfloat16 or g.dtype == torch.float32 for g in t[1])
    _hold(j, t, 2e-3, 0.05)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "zamba2-2.7b"])
def test_remat_off_and_loss_mask(arch):
    """remat changes nothing in the port's numbers (the recompute is the
    same ops), and the masked loss matches the reference's."""
    j, t, tp = run_both(arch, mask=True)
    _hold(j, t, 1e-5, 1e-4)
    cfg = get_smoke_config(arch)
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg, mask=True).items()}
    leaves = tree_leaves(tp)
    loss, (_, aux) = t_tr.train_loss(cfg, tp, batch, remat=False)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert float(loss) == float(t[0])
    for a, b in zip(t[1], grads):
        np.testing.assert_array_equal(a.numpy(), np.zeros(a.shape, np.float32)
                                      if b is None else b.numpy())


def test_forward_hidden_shape_and_streams():
    cfg = get_smoke_config("deepseek-v3-671b")
    tp = params_from_jax(jax.tree.map(np.asarray, _f32(j_tr.init_params(
        j_smoke("deepseek-v3-671b"), jax.random.PRNGKey(1)))), device="cpu")
    tok = torch.from_numpy(smoke_batch(cfg)["tokens"])
    x, aux = t_tr.forward(cfg, tp, tok, remat=False)
    assert tuple(x.shape) == (B, S, cfg.d_model)
    # the prologue's dense layer and the MTP block add no stream
    assert tuple(aux["router_streams"].shape) == (cfg.n_groups, 1, B, S, cfg.moe.top_k)
    assert aux["token_stream"] is tok
