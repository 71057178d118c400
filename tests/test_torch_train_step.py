"""The port's train step, data pipeline and training checkpoint against the
reference, on the CPU at smoke configs.

* ``build_train_step`` over 3 steps of the same batches (4 x 32 tokens, 2
  strided microbatches, remat on) from the reference's exact weights, in
  float32 (every floating leaf cast in both trees), with the reference's
  default ``OptConfig`` (lr 3e-4 after a 100-step warmup): kimi-k2 with
  ``zero1``, ``compress_collective`` and ``grad_compression``; llama3.2-3b
  with AdamW and with Adafactor.  The in-step NeoProf state (the sketch's
  counts, epochs, hot bits and ``n_seen``, ``hot_buf``, ``hot_count``) and
  ``collective_bytes`` bitwise; the losses within 1e-6 and ``gnorm`` within 1e-5 relative,
  every param leaf within 5e-5 of its max, the gradient link's EF
  residuals within one int8 quantum (an element whose round sits at .5 can
  flip) and fewer than 1% of them off by more than 1e-6.  With ``lr`` 1e-2
  the int8 codecs turn the gradients' float32 rounding differences into whole
  quanta, and the router ids then part at near-ties: the bitwise sketch
  holds at the default schedule's small steps.
* ``offload_master`` is the identity on one device (bitwise), and so are
  ``fsdp`` and ``local_grads`` without a mesh.
* Every arch's train step with ``chip_smoke.py``'s PHASE train (b)
  options (``TRAIN_FAMILIES``: between them every single-device option),
  two steps on the CPU: finite losses and gradient norms, every param
  leaf moved or off the loss's path.
* ``SyntheticLM`` and ``MemmapDataset`` batches bitwise the reference's for
  several (step, dp_rank, dp_size).
* The training checkpoint: a port run stopped after step 7 (params,
  optimizer state, sketch and EF through ``ckpt/manager.py``), restored
  into fresh trees and carried to step 12 equals the unbroken 12-step run
  bitwise (AdamW; ZeRO-1 with both codecs); a checkpoint of each optimizer
  state (AdamW, Adafactor, ZeRO-1) restores in the reference's
  ``CheckpointManager`` into the reference's trees, every leaf bitwise.
* The reference's ``test_loss_decreases`` / ``test_moe_loss_decreases`` on
  the port: the loss falls over 12 (10) steps.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.core.neoprof import NeoProfParams as JNPP, neoprof_init as j_npi  # noqa: E402
from repro.core.sketch import SketchParams as JSP  # noqa: E402
from repro.data import pipeline as j_data  # noqa: E402
from repro.dist import compression as j_comp  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.optim import zero1 as j_z1  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager, tree_leaves  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as t_data  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor tests slow down many-fold when each
    worker also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _load_chip_smoke()      # PHASE train's TRAIN_FAMILIES

KIMI, LLAMA = "kimi-k2-1t-a32b", "llama3.2-3b"


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _batches(vocab, n=3, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (4, 32)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
    return out


def _ref_state(cfg, params, tcfg):
    state = {"params": params,
             "prof": j_npi(JNPP(sketch=JSP(width=tcfg.sketch_width)))}
    if tcfg.zero1:
        state["opt"], _ = j_z1.zero1_init(params, None,
                                         compress_collective=tcfg.compress_collective)
    else:
        state["opt"] = j_opt.make_optimizer(tcfg.opt)[0](params)
    if tcfg.grad_compression:
        state["ef"] = j_comp.ef_init(params)
    return state


CASES = {
    "kimi-zero1-int8": (KIMI, dict(zero1=True, compress_collective=True,
                                   grad_compression=True), "adamw"),
    "llama-adamw": (LLAMA, {}, "adamw"),
    "llama-adafactor": (LLAMA, {}, "adafactor"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_three_steps_match_reference(case):
    arch, kw, kind = CASES[case]
    kw = dict(kw, microbatches=2, remat=True)
    jt = j_step.TrainConfig(opt=j_opt.OptConfig(kind=kind), **kw)
    tt = t_step.TrainConfig(opt=OptConfig(kind=kind), **kw)
    jp = _f32(j_tr.init_params(j_smoke(arch), jax.random.PRNGKey(0)))
    jstate = _ref_state(j_smoke(arch), jp, jt)
    tstate = t_step.init_state(get_smoke_config(arch), tt, params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu"), device="cpu")
    jfn = jax.jit(j_step.build_train_step(j_smoke(arch), None, jt))
    tfn = t_step.build_train_step(get_smoke_config(arch), None, tt)
    for b in _batches(j_smoke(arch).vocab):
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tfn(tstate, t_step.to_batch(b, "cpu"))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-6 * float(jm["loss"])
        assert abs(float(jm["gnorm"]) - float(tm["gnorm"])) <= 1e-5 * float(jm["gnorm"])
        assert float(jm["lr"]) == float(tm["lr"])
        if "collective_bytes" in jm:
            assert int(jm["collective_bytes"]) == tm["collective_bytes"]
    for a, b in zip(jax.tree_util.tree_leaves(jstate["params"]),
                    tree_leaves(tstate["params"])):
        a = np.asarray(a)
        assert np.abs(a - _np(b)).max() <= 5e-5 * max(np.abs(a).max(), 1e-30)
    jprof, tprof = jstate["prof"], tstate["prof"]
    for f in ("counts", "epochs", "hot", "n_seen", "cur_epoch", "seeds"):
        np.testing.assert_array_equal(np.asarray(getattr(jprof.sketch, f)),
                                      getattr(tprof.sketch, f).numpy(), err_msg=f)
    for f in ("hot_buf", "hot_count", "dropped", "theta"):
        np.testing.assert_array_equal(np.asarray(getattr(jprof, f)),
                                      getattr(tprof, f).numpy(), err_msg=f)
    if j_smoke(arch).moe is not None:
        assert int(tprof.sketch.n_seen) == 3 * 512     # every id of 3 steps
    if kw.get("zero1"):
        assert set(tstate["opt"]) == set(jstate["opt"]) == {"m", "v", "step", "ef"}
        assert int(tstate["opt"]["step"]) == 3
        assert float(tstate["opt"]["ef"].abs().sum()) > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(jstate["ef"]),
                        tree_leaves(tstate["ef"])):
            diff = np.abs(np.asarray(a) - b.numpy())
            assert diff.max() <= 2 * np.abs(np.asarray(a)).max() + 1e-6
            assert (diff > 1e-6).mean() < 0.01


def _run(arch, tcfg, steps, *, state=None, start=0, ckpt=None, stop=None,
         data_seed=123):
    """The port's loop of the reference's ``tests/test_e2e.py::_train``:
    SyntheticLM batches (4 x 32, seed 123), one step each."""
    cfg = get_smoke_config(arch)
    data = t_data.make_dataset(t_data.DataConfig(seq_len=32, global_batch=4,
                                                 vocab=cfg.vocab, seed=data_seed))
    state = state or t_step.init_state(cfg, tcfg, device="cpu")
    fn = t_step.build_train_step(cfg, None, tcfg)
    losses = []
    for s in range(start, steps):
        state, m = fn(state, t_step.to_batch(data.batch(s, 0, 1), "cpu"))
        losses.append(float(m["loss"]))
        if ckpt is not None and s + 1 == stop:
            ckpt.save(s + 1, state)
    return losses, state


E2E_OPT = OptConfig(lr=3e-3, warmup_steps=2, total_steps=12, weight_decay=0.0)


@pytest.mark.parametrize("arch,steps", [(LLAMA, 12), (KIMI, 10)])
def test_loss_decreases(arch, steps):
    losses, _ = _run(arch, t_step.TrainConfig(opt=E2E_OPT, remat=False), steps)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("zero1", [False, True])
def test_checkpoint_resume_is_exact(tmp_path, zero1):
    tcfg = t_step.TrainConfig(opt=E2E_OPT, microbatches=2, zero1=zero1,
                              compress_collective=zero1, grad_compression=zero1)
    arch = KIMI if zero1 else LLAMA
    full, s_full = _run(arch, tcfg, 12, ckpt=CheckpointManager(str(tmp_path)), stop=7)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    like = t_step.init_state(get_smoke_config(arch), tcfg, seed=5, device="cpu")
    restored = mgr.restore(7, like)
    rest, s_rest = _run(arch, tcfg, 12, state=restored, start=7)
    assert rest == full[7:]
    for a, b in zip(tree_leaves(s_full), tree_leaves(s_rest)):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "zero1"])
def test_checkpoint_restores_in_the_reference(tmp_path, opt):
    kind = "adafactor" if opt == "adafactor" else "adamw"
    tcfg = t_step.TrainConfig(opt=OptConfig(kind=kind, warmup_steps=1),
                              zero1=opt == "zero1", compress_collective=opt == "zero1")
    _, state = _run(LLAMA, tcfg, 1)
    CheckpointManager(str(tmp_path)).save(1, {"params": state["params"],
                                              "opt": state["opt"]})
    jp = j_tr.init_params(j_smoke(LLAMA), jax.random.PRNGKey(3))
    if opt == "zero1":
        jopt, _ = j_z1.zero1_init(jp, None, compress_collective=True)
    else:
        jopt = j_opt.make_optimizer(j_opt.OptConfig(kind=kind))[0](jp)
    got = JManager(str(tmp_path)).restore(1, {"params": jp, "opt": jopt})
    want = tree_leaves({"params": state["params"], "opt": state["opt"]})
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                                      else np.asarray(a), _np(b))
    assert int(got["opt"]["step"]) == 1


def test_offload_master_is_the_identity():
    kw = dict(opt=E2E_OPT, zero1=True, compress_collective=True)
    _, a = _run(LLAMA, t_step.TrainConfig(**kw), 2)
    _, b = _run(LLAMA, t_step.TrainConfig(offload_master=True, **kw), 2)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("arch,kw,kind", CHIP.TRAIN_FAMILIES,
                         ids=[f[0] for f in CHIP.TRAIN_FAMILIES])
def test_train_step_every_arch(arch, kw, kind):
    cfg = get_smoke_config(arch)
    tcfg = t_step.TrainConfig(opt=OptConfig(kind=kind, warmup_steps=1), **kw)
    state = t_step.init_state(cfg, tcfg, device="cpu")
    before = [l.clone() for l in tree_leaves(state["params"])]
    fn = t_step.build_train_step(cfg, None, tcfg)
    data = t_data.SyntheticLM(t_data.DataConfig(seq_len=32, global_batch=4,
                                                vocab=cfg.vocab))
    for i in range(2):
        batch = t_step.to_batch(data.batch(i, 0, 1), "cpu")
        if cfg.n_aux_tokens:             # in the params' dtype, bf16
            batch["aux_embeds"] = torch.randn(
                (4, cfg.n_aux_tokens, cfg.d_model),
                generator=torch.Generator().manual_seed(i)).to(torch.bfloat16)
        state, m = fn(state, batch)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
    moved = [not torch.equal(a, b) for a, b in zip(before, tree_leaves(state["params"]))]
    assert sum(moved) >= len(moved) - 2, moved   # router_bias, a zero gate
    if cfg.moe is not None:
        assert int(state["prof"].sketch.n_seen) == 2 * 4 * 32 * cfg.moe.top_k * cfg.n_groups


def test_mesh_only_options_raise():
    """Once a refusal of the mesh options, now the reference's no-ops
    without a mesh: ``fsdp`` and ``local_grads`` leave the meshless step
    bitwise unchanged (params, moments, metrics), as the reference's
    ``state_shardings`` apply only on a mesh and its ``local_grads`` branch
    needs one."""
    cfg = get_smoke_config(LLAMA)
    runs = []
    for kw in ({}, {"fsdp": True, "local_grads": True}):
        tcfg = t_step.TrainConfig(opt=E2E_OPT, microbatches=2, **kw)
        state = t_step.init_state(cfg, tcfg, device="cpu")
        fn = t_step.build_train_step(cfg, None, tcfg)
        metrics = []
        for b in _batches(cfg.vocab, n=2):
            state, m = fn(state, t_step.to_batch(b, "cpu"))
            metrics.append(sorted((k, float(v)) for k, v in m.items()))
        runs.append((metrics, tree_leaves(state)))
    (ma, la), (mb, lb) = runs
    assert ma == mb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("step,rank,size", [(0, 0, 1), (7, 0, 1), (3, 1, 2), (11, 3, 4)])
def test_synthetic_batches_bitwise(step, rank, size):
    cfg = dict(seq_len=48, global_batch=8, vocab=1000, seed=77)
    want = j_data.SyntheticLM(j_data.DataConfig(**cfg)).batch(step, rank, size)
    got = t_data.make_dataset(t_data.DataConfig(**cfg)).batch(step, rank, size)
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(want[k], got[k])


def test_memmap_batches_bitwise(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 5000, 40_000).astype(np.int32).tofile(path)
    cfg = dict(seq_len=64, global_batch=4, seed=9, path=str(path))
    jd = j_data.make_dataset(j_data.DataConfig(**cfg))
    td = t_data.make_dataset(t_data.DataConfig(**cfg))
    assert isinstance(td, t_data.MemmapDataset)
    for step, rank, size in [(0, 0, 1), (5, 1, 2), (1000, 0, 4)]:
        want, got = jd.batch(step, rank, size), td.batch(step, rank, size)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(want[k], got[k])
