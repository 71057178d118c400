"""The train step over a mesh against the single-device step, on the CPU.

Two float32 steps of the smoke configs (8 x 32 tokens, 2 strided
microbatches) run in one gloo world of 8 ranks
(``tests/torch_dist_world.py``): llama3.2-3b on the (2, 4) ``("data",
"model")`` mesh with ``fsdp`` (AdamW, and Adafactor, whose factored
moments rest as blocks) and with ZeRO-1 (``compress_collective``,
``offload_master``, ``fsdp``), and on (2, 4) and (4, 1) meshes (two, each a
half of the world) with ``local_grads`` with and without
``grad_compression``; gemma2-27b (softcaps, post-norms, GeGLU, the local
window) on the (4, 2) mesh with the same options but the compressed link;
kimi-k2 expert-parallel (``EPContext``) on (2, 4), with remat; zamba2-2.7b
with ``fsdp`` on (2, 4) and xlstm-1.3b under Adafactor on (1, 8) (mLSTM's
4 heads over 8 ranks: two ranks a head).  Over
'model' the dense decoders compute their share: llama's 4/2 heads do not
divide the (2, 4) mesh's 4 'model' ranks (the attention core split by
query rows), gemma2's divide the (4, 2) mesh's 2 (split by heads).  Each
is held to the
reference's single-device step (jitted; its ZeRO-1 quantizing the delta
per mesh rank's slice, as the mesh's does), run here on the same numpy
weights and batches, and to the port's own meshless step:

* loss and gradient norm of each step, and every param after two steps,
  within 1e-5 + 1e-5 |ref| (the reference's sharded test used 1e-2 in
  bf16);
* ``dp_psum_bytes`` equal to the reference's ``psum_bytes``;
* under ``grad_compression`` the reference is the compressed sum's formula
  evaluated in one process: each data rank's microbatch gradients through
  the reference's ``value_and_grad``, quantized per tensor with its EF
  residual, summed, then AdamW; the residuals within one int8 quantum;
* kimi-k2's in-step sketch (the router stream gathered over the data
  ranks) bitwise the meshless step's and the reference's.

The gradients are the single-device gradients of the whole batch: the
ranks' sums are divided by the microbatches times the data ranks (the
reference's ``local_grads`` divides by the microbatches alone).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.core.neoprof import NeoProfParams as JNPP, neoprof_init as j_npi  # noqa: E402
from repro.core.sketch import SketchParams as JSP  # noqa: E402
from repro.dist import compression as j_comp  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.optim import zero1 as j_z1  # noqa: E402
from repro.tiering import codec as j_codec  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.dist.sharding import tree_map_with_path  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402

import torch_dist_world as tw  # noqa: E402

LLAMA, KIMI, GEMMA = "llama3.2-3b", "kimi-k2-1t-a32b", "gemma2-27b"
DEEPSEEK, ZAMBA, XLSTM = "deepseek-v3-671b", "zamba2-2.7b", "xlstm-1.3b"
VISION, WHISPER = "llama-3.2-vision-11b", "whisper-base"
CROSS_GATE = 0.5          # the cross block's xgate (drawn as 0), so that the image counts
MESH_DP = {"2x4": 2, "4x1": 4, "4x2": 4, "1x8": 1}
MESH_SIZE = {"2x4": 8, "4x1": 4, "4x2": 8, "1x8": 8}
# steps that move the params: lr 1e-2 from step 1, and an eps that keeps
# AdamW's first update g / (|g| + eps) from turning the summation-order
# noise of gradient elements near 0 into whole steps
FAST = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
CASES = {
    "fsdp": (LLAMA, dict(fsdp=True), FAST),
    "local": (LLAMA, dict(local_grads=True), FAST),
    # int8 quanta (the gradients', the delta's): the default schedule's small
    # steps keep a rounding flip of one element inside the bound
    "local-int8": (LLAMA, dict(local_grads=True, grad_compression=True), {}),
    "zero1": (LLAMA, dict(zero1=True, compress_collective=True, offload_master=True,
                          fsdp=True), {}),
    # Adafactor's factored moments rest as blocks (vr, vc under the param's
    # spec less a dim), gathered for the update
    "adafactor": (LLAMA, dict(fsdp=True), dict(FAST, kind="adafactor")),
}
CASES.update({f"gemma2-{case}": (GEMMA,) + CASES[case][1:]
              for case in ("fsdp", "local", "zero1", "adafactor")})
# deepseek-v3 under Adafactor, the dry run's optimizer for the MoE archs:
# MLA, the dense prologue, the shared expert and the MTP head partitioned,
# the experts expert-parallel, the factored moments updated from blocks
CASES["deepseek-adafactor"] = (DEEPSEEK, dict(fsdp=True), dict(FAST, kind="adafactor"))
# the recurrent archs: zamba2's Mamba2 mixers (in_proj gathered whole, B | C
# split and gathered) and shared attention block on (2, 4); xlstm's mLSTM
# (4 heads over 8 ranks: two a head) and sLSTM on (1, 8) under Adafactor
CASES["zamba2-fsdp"] = (ZAMBA, dict(fsdp=True), FAST)
CASES["xlstm-adafactor"] = (XLSTM, dict(fsdp=True), dict(FAST, kind="adafactor"))
# the cross-attention archs over their batches' aux_embeds: llama-vision's
# self attention by query rows (4/2 heads on 4) and its gated cross block by
# query rows on (2, 4); whisper's 4 heads over 8 ranks on (1, 8): its
# decoder's self and cross attention by query rows, its encoder's 25 frames
# by head columns (two ranks a head)
CASES["vision-fsdp"] = (VISION, dict(fsdp=True), FAST)
CASES["whisper-fsdp"] = (WHISPER, dict(fsdp=True), FAST)
# leaves that compute their share over 'model': the embedding table, q/k/v/o
# and the MLP's three matrices of each pattern position; a MoE arch's
# attention (GQA's q/k/v/o, MLA's wq_a/wq_b/wkv_a/wkv_b/wo) and MLP of each
# prologue layer, each MoE block's attention and shared expert
# (sh_gate/sh_in/sh_out), and deepseek-v3's MTP projection and block
# zamba2's in_proj, conv_w and out_proj of each Mamba2 position and its
# shared block's q/k/v/o and MLP; xlstm's mLSTM wq/wk/wv/ogate/wo (wi and wf,
# (d, 4), do not split 8 ways) and sLSTM wz/wi/wf/wo_gate/wo; llama-vision's
# five blocks' q/k/v/o and MLPs and its cross block's xattn q/k/v/o;
# whisper's dec block's q/k/v/o, gelu MLP (w_in, w_out) and xattn, and each
# of its 2 encoder blocks' q/k/v/o and MLP
SPLIT_LEAVES = {LLAMA: 1 + 7, GEMMA: 1 + 2 * 7, KIMI: 1 + (4 + 3) + (4 + 3),
                DEEPSEEK: 1 + (5 + 3) + (5 + 3) + 1 + (5 + 3),
                ZAMBA: 1 + 2 * 3 + (4 + 3), XLSTM: 1 + 5 + 5,
                VISION: 1 + 5 * 7 + 4, WHISPER: 1 + (4 + 2 + 4) + 2 * (4 + 2)}
MOE_ARCHS = (KIMI, DEEPSEEK)
ONE_RANK_ARCHS = MOE_ARCHS + (ZAMBA, XLSTM, VISION, WHISPER)


# the data-parallel reduce's cases on both meshes; the rest on (2, 4) (the
# ranks' gloo collectives are what a loaded suite waits on)
MESHES = {"fsdp": ("2x4",), "local": ("2x4", "4x1"), "local-int8": ("2x4", "4x1"),
          "zero1": ("2x4",), "adafactor": ("2x4",), "kimi-ep": ("2x4",),
          "gemma2-fsdp": ("4x2",), "gemma2-local": ("4x2",), "gemma2-zero1": ("4x2",),
          "gemma2-adafactor": ("4x2",), "deepseek-adafactor": ("2x4",),
          "zamba2-fsdp": ("2x4",), "xlstm-adafactor": ("1x8",),
          "vision-fsdp": ("2x4",), "whisper-fsdp": ("1x8",)}


def _runs():
    return [(f"{case}@{mesh}", case, mesh) for case in MESHES for mesh in MESHES[case]]


def _spec(case):
    if case == "kimi-ep":
        return KIMI, {}, {}
    return CASES[case]


@functools.lru_cache(maxsize=None)
def _params(arch):
    """Float32 smoke params as numpy, both sides' weights (the port's draw;
    a cross block's gate at CROSS_GATE)."""
    p = t_tr.init_params(get_smoke_config(arch), 0, device="cpu")
    return tree_map_with_path(lambda path, x: np.full(x.shape, CROSS_GATE, np.float32)
                              if path.endswith("xgate") else x.float().numpy(), p)


@functools.lru_cache(maxsize=None)
def _batches(arch):
    """Two batches of 8 x 32 tokens and, for a cross-attention arch, their
    (8, n_aux_tokens, d) float32 ``aux_embeds``."""
    cfg = get_smoke_config(arch)
    rng, aux_rng = np.random.default_rng(21), np.random.default_rng(23)
    out = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
        if cfg.n_aux_tokens:
            out[-1]["aux_embeds"] = aux_rng.normal(
                0, 1, (8, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)
    return tuple(out)


def _kw(case):
    """Remat (each group's gather run again in the backward) on the
    expert-parallel case, off elsewhere to halve the collectives."""
    return dict(_spec(case)[1], microbatches=2, remat=case == "kimi-ep")


def _checks():
    out = []
    for name, case, mesh in _runs():
        arch, _, opt = _spec(case)
        out.append((name, "check_train",
                    dict(mesh=mesh, arch=arch, params=_params(arch),
                         batches=list(_batches(arch)),
                         kw=_kw(case), opt=opt)))
    for arch in ONE_RANK_ARCHS:
        cfg = get_smoke_config(arch)
        batches = _batches(arch)
        out.append((f"one_rank_{arch}", "check_one_rank",
                    dict(arch=arch, params=_params(arch), batches=list(batches),
                         prompt=np.random.default_rng(22).integers(0, cfg.vocab, (2, 8))
                         .astype(np.int32),
                         aux=batches[0]["aux_embeds"][:2] if cfg.n_aux_tokens else None)))
    return out


@pytest.fixture(scope="module", autouse=True)
def world():
    """The ranks' run, with the oracles worked out here while it goes."""
    w = tw.World(_checks())
    try:
        for _, case, mesh in _runs():
            if case == "local-int8":
                _reference_compressed(mesh)
            else:
                _reference(case, mesh)
            _meshless(case)
        yield w
    finally:
        w.close()


def _result(world, name, rank=0):
    res = world.results()[rank][name]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank}, check {name}:\n{res['error']}")
    return res


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert not bad.any(), (what, float(np.abs(got - want).max()))


# -- the reference's single-device oracles ---------------------------------------

def _ref_state(arch, tcfg):
    params = jax.tree.map(jnp.asarray, _params(arch))
    state = {"params": params, "prof": j_npi(JNPP(sketch=JSP(width=tcfg.sketch_width)))}
    if tcfg.zero1:
        state["opt"], _ = j_z1.zero1_init(params, None,
                                         compress_collective=tcfg.compress_collective)
    else:
        state["opt"] = j_opt.make_optimizer(tcfg.opt)[0](params)
    if tcfg.grad_compression:
        state["ef"] = j_comp.ef_init(params)
    return state


def _reference(case, mesh):
    """The reference's single-device step over the two batches -> (metrics,
    params, sketch arrays).  ``fsdp`` and ``local_grads`` are no-ops there,
    so the cases that differ only in them share one run; its ZeRO-1
    quantizes per mesh rank's slice."""
    arch, kw, opt = _spec(case)
    zero1 = {k: v for k, v in kw.items() if k not in ("fsdp", "local_grads")}
    return _reference_run(arch, tuple(sorted(opt.items())), tuple(sorted(zero1.items())),
                          MESH_SIZE[mesh] if zero1.get("zero1") else 1)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, opt, kw, n_shards):
    cfg = j_smoke(arch)
    # remat off: the same values, and a much faster compile
    tcfg = j_step.TrainConfig(opt=j_opt.OptConfig(**dict(opt)), microbatches=2,
                              remat=False, **dict(kw))
    saved = j_z1._n_shards
    j_z1._n_shards = lambda m: n_shards
    try:
        state = _ref_state(arch, tcfg)
        step = jax.jit(j_step.build_train_step(cfg, None, tcfg))
        metrics = []
        for b in _batches(arch):
            state, m = step(state, jax.tree.map(jnp.asarray, b))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        j_z1._n_shards = saved
    prof = state["prof"]
    sketch = [np.asarray(getattr(prof.sketch, f)) for f in ("counts", "epochs", "hot",
                                                          "n_seen")]
    sketch += [np.asarray(prof.hot_buf), np.asarray(prof.hot_count)]
    return metrics, [np.asarray(x) for x in jax.tree_util.tree_leaves(state["params"])], sketch


@functools.lru_cache(maxsize=None)
def _reference_compressed(mesh):
    """``local_grads`` + ``grad_compression`` in one process: each data
    rank's rows through the reference's loss and gradient, the compressed
    sum's formula over the ranks, the mean over the whole batch, AdamW."""
    arch, _, opt = _spec("local-int8")
    cfg = j_smoke(arch)
    n, m = MESH_DP[mesh], 2
    ocfg = j_opt.OptConfig(**opt)
    params = jax.tree.map(jnp.asarray, _params(arch))
    ostate = j_opt.adamw_init(params)
    ef = j_comp.ef_init(params)

    @jax.jit
    def step(params, ostate, ef, parts):
        sums, lsum = [], 0.0
        for part in parts:                 # a data rank's rows
            g_d = None
            for i in range(m):
                loss, g = jax.value_and_grad(lambda p: j_tr.train_loss(
                    cfg, p, {k: v[i::m] for k, v in part.items()}, remat=False)[0])(params)
                lsum = lsum + loss
                g_d = g if g_d is None else jax.tree.map(jnp.add, g_d, g)
            sums.append(g_d)
        xs = [jax.tree.map(jnp.add, g, ef) for g in sums]
        applied = [jax.tree.map(lambda x: j_codec.dequantize_int8(
            *j_codec.quantize_int8(x), jnp.float32), x) for x in xs]
        total = functools.reduce(lambda a, c: jax.tree.map(jnp.add, a, c), applied)
        ef = jax.tree.map(lambda *r: sum(r[1:], r[0]) / n,
                          *[jax.tree.map(jnp.subtract, x, a) for x, a in zip(xs, applied)])
        grads = jax.tree.map(lambda g: g / (m * n), total)
        params, ostate, om = j_opt.adamw_update(ocfg, params, grads, ostate)
        scale = [jnp.abs(x).max() for x in jax.tree_util.tree_leaves(xs[0])]
        return params, ostate, ef, lsum / (m * n), om["gnorm"], scale

    wire = j_comp.psum_bytes(params, compressed=True)
    metrics = []
    for b in _batches(arch):
        rows = b["tokens"].shape[0] // n
        parts = [{k: jnp.asarray(v[d * rows:(d + 1) * rows]) for k, v in b.items()}
                 for d in range(n)]
        params, ostate, ef, loss, gnorm, scale = step(params, ostate, ef, parts)
        metrics.append({"loss": float(loss), "gnorm": float(gnorm), "dp_psum_bytes": wire})
    return (metrics, [np.asarray(x) for x in jax.tree_util.tree_leaves(params)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(ef)],
            [float(x) for x in scale])


def _meshless(case):
    """The port's meshless step from the same weights and batches (the
    mesh-only options are no-ops there, and the runs are shared)."""
    arch, kw, opt = _spec(case)
    return _meshless_run(arch, tuple(sorted(opt.items())), tuple(sorted(
        (k, v) for k, v in kw.items() if k not in ("fsdp", "local_grads"))))


@functools.lru_cache(maxsize=None)
def _meshless_run(arch, opt, kw):
    opt, kw = dict(opt), dict(kw, microbatches=2, remat=True)
    cfg = get_smoke_config(arch)
    tcfg = t_step.TrainConfig(opt=OptConfig(**opt), **kw)
    params = tree_map_with_path(lambda _, x: torch.from_numpy(x.copy()), _params(arch))
    state = t_step.init_state(cfg, tcfg, params, device="cpu")
    fn = t_step.build_train_step(cfg, None, tcfg)
    metrics = []
    for b in _batches(arch):
        state, mm = fn(state, t_step.to_batch(b, "cpu"))
        metrics.append({k: float(v) for k, v in mm.items()})
    return metrics, state


# -- the cases --------------------------------------------------------------------

@pytest.mark.parametrize("name,case,mesh", _runs(), ids=[r[0] for r in _runs()])
def test_train_step_over_a_mesh_matches_single_device(world, name, case, mesh):
    arch = _spec(case)[0]
    res = _result(world, name)
    if case == "local-int8":
        metrics, params, ef, scales = _reference_compressed(mesh)
        quantum = max(scales) / 127
        for a, b in zip(res["ef"], ef):
            diff = np.abs(a - b)
            assert diff.max() <= quantum and (diff > 1e-6).mean() < 0.01
    else:
        metrics, params, sketch = _reference(case, mesh)
        if arch in MOE_ARCHS:
            for a, b in zip(res["sketch"], sketch):
                np.testing.assert_array_equal(a, b)
            assert int(res["sketch"][3]) == 2 * 8 * 32 * 2 * get_smoke_config(arch).n_groups
    for got, want in zip(res["metrics"], metrics):
        for k in ("loss", "gnorm"):
            _close(got[k], want[k], k)
        if "dp_psum_bytes" in got:
            want_b = want.get("dp_psum_bytes") or j_comp.psum_bytes(
                jax.tree.map(jnp.asarray, _params(arch)),
                compressed=_kw(case).get("grad_compression", False))
            assert got["dp_psum_bytes"] == want_b
        if "collective_bytes" in want:
            assert got["collective_bytes"] == want["collective_bytes"]
    assert ("dp_psum_bytes" in res["metrics"][0]) == _kw(case).get("local_grads", False)
    n_split, n_gathered = res["split"]      # every arch here is partitioned
    assert n_split == SPLIT_LEAVES[arch] and n_gathered == 0, res["split"]
    for a, b in zip(res["params"], params):
        _close(a, b, "params")
    # the port's meshless step holds to the same bounds (its compressed
    # link is another codec, so that case compares the step before it)
    ml, mstate = _meshless(case)
    _close(ml[0]["loss"], res["metrics"][0]["loss"], "meshless loss")
    if case != "local-int8":
        for got, want in zip(ml, res["metrics"]):
            _close(got["gnorm"], want["gnorm"], "meshless gnorm")
        from repro_torch.ckpt.manager import tree_leaves
        for a, b in zip(tree_leaves(mstate["params"]), res["params"]):
            _close(a.numpy(), b, "meshless params")
    if arch in MOE_ARCHS:
        prof = mstate["prof"]
        mine = [getattr(prof.sketch, f).numpy() for f in ("counts", "epochs", "hot",
                                                          "n_seen")]
        mine += [prof.hot_buf.numpy(), prof.hot_count.numpy()]
        for a, b in zip(res["sketch"], mine):
            np.testing.assert_array_equal(a, b)


def test_every_rank_holds_the_same_step(world):
    """The replicated results (metrics, gathered params) agree on every
    rank of a mesh, and the two (4, 1) halves agree with each other; so do
    every rank's own copies of the replicated params (norms, biases), which
    the partitioned layers' ranks each update from gradients summed over
    'model'."""
    for name, _, mesh in _runs():
        base = _result(world, name)
        for rank in range(1, tw.WORLD):
            other = _result(world, name, rank)
            assert other["metrics"] == base["metrics"], (name, rank)
            for a, b in zip(other["replicated"], base["replicated"]):
                np.testing.assert_array_equal(a, b)
            if rank in (3, 4, 7):
                for a, b in zip(other["params"], base["params"]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ONE_RANK_ARCHS)
def test_one_model_rank_is_the_meshless_arithmetic(world, arch):
    """At one 'model' rank every partitioned form (the MoE archs', the
    recurrent archs') is the meshless arithmetic op for op: two train
    steps over a (1, 1) mesh, AdamW and
    Adafactor (from blocks), every param bitwise the meshless step's (the
    expert-parallel body off: its ``enter`` regroups x's gradient sum, so
    with it the params agree to ~1e-7, as the cases above hold); the
    partitioned paged prefill and decode, dense prefill (its cache's
    sequence split over the one rank, every attention block attending its
    block of it) and prefill, the experts expert-parallel, every logit and
    cache leaf bitwise."""
    res = _result(world, f"one_rank_{arch}")
    assert res["adamw"] == 0 and res["adafactor"] == 0, res
    assert res["serve"] == 0 and res["n_serve"] > 10, res
    assert (res["dense_split"] > 0) == (arch != XLSTM), res
