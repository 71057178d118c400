"""The port's Mamba2 and xLSTM modules and their two archs (zamba2-2.7b,
xlstm-1.3b) against the reference, on the CPU at smoke widths, from the
reference's exact weights (``params_from_jax``).

* The params tree (names, shapes, dtypes; zamba2's ``{}`` blocks at its
  ``shared_attn`` positions and the one ``params["shared_attn"]`` block,
  carried across by ``params_from_jax``); ``init_cache`` and
  ``init_paged_cache`` layouts and initial values (the stabiliser ``m`` at
  -1e30).  The configs are ``tests/test_torch_archs.py``'s.
* ``mamba2_decode``, ``mlstm_decode`` and ``slstm_decode`` over 12 steps:
  in float32 the output within 1e-5 and every state leaf within 1e-5 of
  its scale (summation order only: the mLSTM/sLSTM normaliser ``n`` grows
  past 5); in bf16, where the in-process reference rounds its fused bf16
  chains once (ROADMAP C2), the output within 2^-5 of its scale (a few
  bf16 ulps) and the float32 states within 2^-5 relative.
* Lane masks: 20 masked ``decode_step_paged`` steps over 3 lanes against
  the reference's step and ``merge_cache``, float32: active lanes' logits
  within 1e-4, page mass within 1e-5, K/V rows within 1e-5 and states
  within 1e-5 of their scale; an inactive lane's states, rings and
  position bitwise unchanged.
* ROADMAP P2: a lane reused after a finished request serves exactly as a
  fresh engine (the port of ``tests/test_sched.py::
  test_reset_lane_restores_init_state_xlstm``), and ``reset_lane`` puts
  every recurrent state back to its initial value.
* ``chip_smoke.py``'s PHASE ssm lane drive over its cut of the lane trace:
  each arch's schedule at its smoke config, which the phase holds the
  card's run to, is llama3.2-3b's over the same cut (no scheduling
  decision reads a token, a lane's state or the arch), and preempts a
  request and reuses a lane.
* ``check_ported`` accepts the hybrid and ``ssm`` families and refuses
  their blocks outside them.
* gemma2-smoke (``attn_local`` + ``attn_global``: the sibling ring travels
  in ``preempt_lane``'s residual) through a forced preemption on the
  scheduler, bf16, bitwise against the reference run in a subprocess
  (tokens, steps, TierStats, placement tables, θ traces).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import mamba2 as j_m2  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.models import xlstm as j_xl  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mamba2 as t_m2  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models import xlstm as t_xl  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402
from test_torch_archs import (STATE_KEYS, _f32, _flatten, _np,  # noqa: E402
                              state_tol)
from test_torch_dense import _gelu_op_by_op  # noqa: E402
from test_torch_reuse import stop_reference, wait_reference  # noqa: E402
from test_torch_sched import CHIP, _assert_same, _silu_op_by_op, drive  # noqa: E402
from test_torch_ssm_serve import CASES, start_multi_reference  # noqa: E402

ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
STEPS, B, D = 12, 2, 64
PAGE_T, SLOTS = 4, 4
BF16_TOL = 2 ** -5


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(arch):
    """Same tree, shapes and dtypes as the reference's init; the per-head
    vectors and norms at the reference's values."""
    cfg = j_smoke(arch)
    ref = j_tr.init_params(cfg, jax.random.PRNGKey(0))
    port = t_tr.init_params(t_registry.get_smoke_config(arch), seed=0, device="cpu")
    port_flat = dict(_flatten(port))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert set(port_flat) == {jax.tree_util.keystr(p) for p, _ in ref_leaves}
    for path, leaf in ref_leaves:
        key = jax.tree_util.keystr(path)
        assert tuple(port_flat[key].shape) == leaf.shape, key
        assert str(port_flat[key].dtype).split(".")[-1] == str(leaf.dtype), key
        if key.split("['")[-1] in ("A_log']", "D']", "dt_bias']", "norm']",
                                   "f_bias']", "conv_b']", "scale']"):
            np.testing.assert_allclose(_np(port_flat[key]),
                                       np.asarray(leaf, np.float32), rtol=1e-6,
                                       err_msg=key)
    if arch == "zamba2-2.7b":
        assert [port["blocks"][i] == {} for i in range(3)] == [False, False, True]
        assert set(port["shared_attn"]) == {"ln1", "ln2", "attn", "ffn"}


def test_params_from_jax_carries_shared_attn_and_empty_blocks():
    jp = j_tr.init_params(j_smoke("zamba2-2.7b"), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["blocks"][2] == {} and jp["blocks"][2] == {}
    want = dict(_flatten(jax.tree.map(np.asarray, jp["shared_attn"])))
    got = dict(_flatten(tp["shared_attn"]))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(_np(got[k]), np.asarray(v, np.float32)), k


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference(arch, paged):
    """Keys, shapes, dtypes and initial values of both caches: the O(1)
    states (``m`` at -1e30) and zamba2's ``shared_attn`` cache or ring."""
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    if paged:
        ref = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T, per_lane_pos=True)
        port = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, per_lane_pos=True,
                                      device="cpu")
    else:
        ref = j_dec.init_cache(cfg, B, 16)
        port = t_dec.init_cache(tcfg, B, 16, device="cpu")
    assert set(port) == set(ref) and len(port["blocks"]) == len(ref["blocks"])
    assert tuple(port["pos"].shape) == ref["pos"].shape
    for got, want in zip(port["blocks"], ref["blocks"]):
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
            assert np.array_equal(_np(got[k]), np.asarray(v, np.float32)), k
    if arch == "xlstm-1.3b":
        assert all(bool((e["m"] == -1e30).all()) for e in port["blocks"])


# -- the modules, 12 recurrent steps ------------------------------------------------

def _module_case(kind, dtype):
    """(reference params, port params, reference decode, port decode,
    reference cache, port cache) of one smoke-width layer."""
    key = jax.random.PRNGKey(11)
    s = j_smoke("zamba2-2.7b").ssm
    if kind == "mamba":
        jp = j_m2.mamba2_init(key, D, d_state=s.d_state, expand=s.expand,
                              headdim=s.headdim, d_conv=s.d_conv)
        kw = dict(headdim=s.headdim, n_groups=s.n_groups, d_state=s.d_state)
        jfn, tfn = (functools.partial(j_m2.mamba2_decode, **kw),
                    functools.partial(t_m2.mamba2_decode, **kw))
        jc = j_m2.mamba2_init_cache(B, jp, **kw)
        tc = t_m2.mamba2_init_cache(B, D, expand=s.expand, d_conv=s.d_conv,
                                    dtype=dtype, device="cpu", **kw)
    elif kind == "mlstm":
        jp = j_xl.mlstm_init(key, D, n_heads=4)
        jfn = functools.partial(j_xl.mlstm_decode, n_heads=4)
        tfn = functools.partial(t_xl.mlstm_decode, n_heads=4)
        jc, tc = j_xl.mlstm_init_cache(B, D, 4), t_xl.mlstm_init_cache(
            B, D, 4, device="cpu")
    else:
        jp = j_xl.slstm_init(key, D)
        jfn, tfn = j_xl.slstm_decode, t_xl.slstm_decode
        jc, tc = j_xl.slstm_init_cache(B, D), t_xl.slstm_init_cache(B, D,
                                                                    device="cpu")
    if dtype == torch.float32:
        jp = _f32(jp)
        jc = _f32(jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp, jax.jit(jfn), tfn, jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_module_decode_matches_reference(kind, dtype):
    """12 recurrent steps from the initial state on seeded inputs."""
    tdt = getattr(torch, dtype)
    jp, tp, jfn, tfn, jc, tc = _module_case(kind, tdt)
    u = np.random.default_rng(4).normal(0, 1, (STEPS, B, 1, D)).astype(np.float32)
    for i in range(STEPS):
        ju = jnp.asarray(u[i], jnp.dtype(dtype))
        jy, jc = jfn(jp, ju, jc)
        ty, tc = tfn(tp, torch.from_numpy(u[i]).to(tdt), tc)
        want, got = np.asarray(jy, np.float32), _np(ty)
        assert ty.dtype == tdt and got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=f"{kind} y step {i}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=f"{kind} y {i}",
                                       atol=BF16_TOL * float(np.abs(want).max()))
        for k in jc:
            w, g = np.asarray(jc[k], np.float32), _np(tc[k])
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=state_tol(w), rtol=0,
                                           err_msg=f"{kind} {k} step {i}")
            else:
                np.testing.assert_allclose(g, w, rtol=0, err_msg=f"{kind} {k} {i}",
                                           atol=BF16_TOL * float(np.abs(w).max()))


def test_slstm_and_mlstm_first_step_forget_nothing():
    """With ``m`` at -1e30 the first step's carried share ``exp(logf + m -
    m_new)`` is exactly 0: the new state is the input's alone, whatever was
    in ``c`` and ``n``."""
    for kind in ("mlstm", "slstm"):
        _, tp, _, tfn, _, tc = _module_case(kind, torch.float32)
        u = torch.randn((B, 1, D), generator=torch.Generator().manual_seed(0))
        clean = tfn(tp, u, tc)
        dirty = dict(tc, c=tc["c"] + 7.0, n=tc["n"] + 3.0)
        for a, b in zip(clean[1].values(), tfn(tp, u, dirty)[1].values()):
            assert torch.equal(a, b), kind
        assert torch.equal(clean[0], tfn(tp, u, dirty)[0])


# -- lane masks over the arch, float32 ----------------------------------------------

MASKS = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 1], [0, 0, 1],
         [1, 0, 1], [1, 1, 1], [0, 1, 0], [1, 0, 1]] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_lane_mask_matches_reference_merge(arch):
    """20 masked steps over 3 lanes against the reference's step and
    ``merge_cache``; an inactive lane's leaves bitwise unchanged."""
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jp = _f32(j_tr.init_params(cfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jc = j_dec.init_paged_cache(cfg, 3, SLOTS, PAGE_T, dtype=jnp.float32,
                                per_lane_pos=True)
    tc = t_dec.init_paged_cache(tcfg, 3, SLOTS, PAGE_T, dtype=torch.float32,
                                per_lane_pos=True, device="cpu")
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg,
                                      page_t=PAGE_T, return_streams=True))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (len(MASKS), 3, 1))
    for step, mask in enumerate(MASKS):
        act = np.asarray(mask, bool)
        idle = torch.from_numpy(np.flatnonzero(~act))
        before = [{k: v.index_select(1, idle).clone() for k, v in e.items()}
                  for e in tc["blocks"]]
        pos_before = tc["pos"][idle].clone()
        jl, jn, js = jstep(jp, jc, jnp.asarray(toks[step]))
        jc = j_dec.merge_cache(jc, jn, jnp.asarray(act))
        tl, tc, ts = t_dec.decode_step_paged(
            tcfg, tp, tc, torch.from_numpy(toks[step]), page_t=PAGE_T,
            return_streams=True, active=torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   atol=1e-4, rtol=0, err_msg=f"logits {step}")
        if js["kv_mass"] is None:
            assert ts["kv_mass"] is None
        else:
            np.testing.assert_allclose(ts["kv_mass"].numpy()[:, :, act],
                                       np.asarray(js["kv_mass"])[:, :, act],
                                       atol=1e-5, rtol=0, err_msg=f"mass {step}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert torch.equal(tc["pos"][idle], pos_before)
        for i, (got, want, old) in enumerate(zip(tc["blocks"], jc["blocks"],
                                                 before)):
            for k in want:
                w = np.asarray(want[k])[:, act]
                if w.dtype.kind == "f":
                    tol = state_tol(w) if k in STATE_KEYS else 1e-5
                    np.testing.assert_allclose(_np(got[k])[:, act], w, rtol=0,
                                               atol=tol, err_msg=f"{i} {k} {step}")
                else:
                    np.testing.assert_array_equal(_np(got[k])[:, act], w)
                assert torch.equal(got[k].index_select(1, idle), old[k]), \
                    f"inactive lane's {i} {k} changed at step {step}"


def test_check_ported_accepts_the_recurrent_families():
    zamba, xl = (t_registry.get_smoke_config(a) for a in ARCHS)
    for cfg in (zamba, xl, t_registry.get_config(ARCHS[0]),
                t_registry.get_config(ARCHS[1])):
        t_tr.check_ported(cfg)
    for bad in (dataclasses.replace(zamba, pattern=("mamba", "mlstm")),
                dataclasses.replace(zamba, pattern=("mamba", "attn")),
                dataclasses.replace(zamba, ssm=None),
                dataclasses.replace(xl, pattern=("mlstm", "mamba")),
                dataclasses.replace(xl, pattern=("mlstm", "shared_attn")),
                dataclasses.replace(xl, encoder_layers=2, n_layers=6)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_tr.check_ported(bad)


# -- ROADMAP P2: a reset lane restarts from the initial states -----------------------

def test_reset_lane_restores_init_state_xlstm():
    """A reused lane serves like a fresh engine even though the m/sLSTM
    stabiliser does not start at zero (the port of the reference's test of
    the same name, its weights from ``PRNGKey(1)``)."""
    cfg = t_registry.get_smoke_config("xlstm-1.3b")
    params = params_from_jax(jax.tree.map(np.asarray, j_tr.init_params(
        j_smoke("xlstm-1.3b"), jax.random.PRNGKey(1))), device="cpu")
    lane_kw = dict(max_seq=32, paged=True, page_t=4, hot_slots=4,
                   migration_interval=4)
    eng = t_engine.ServeEngine(cfg, params, t_engine.ServeConfig(**lane_kw, lanes=1),
                               device="cpu")
    sched = t_sched.Scheduler(eng, [t_sched.Tenant("a")])
    pa = ((np.arange(7) * 5 + 2) % cfg.vocab).astype(np.int32)
    pb = ((np.arange(6) * 11 + 3) % cfg.vocab).astype(np.int32)
    sched.submit("a", pa, max_new=4)
    rb = sched.submit("a", pb, max_new=6)       # admitted into the reused lane
    sched.run(max_steps=100)
    ref = t_engine.ServeEngine(cfg, params, t_engine.ServeConfig(**lane_kw),
                               device="cpu")
    assert rb.out == list(ref.generate(pb[None], n_tokens=6)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_lane_restores_every_initial_state(arch):
    """After a request has moved every state, ``reset_lane`` puts the
    lane's recurrent states (``m`` at -1e30, the rest at 0), ring
    bookkeeping and position back where ``init_paged_cache`` starts them;
    the other lane is untouched."""
    cfg = t_registry.get_smoke_config(arch)
    eng = t_engine.ServeEngine(cfg, t_tr.init_params(cfg, seed=0, device="cpu"),
                               t_engine.ServeConfig(max_seq=32, paged=True, page_t=4,
                                                    hot_slots=4, lanes=2),
                               device="cpu")
    eng.start_lanes()
    for lane in (0, 1):
        eng.prefill_lane(lane, np.arange(5) + 3 * lane, lane)
    other = [{k: v[:, 1].clone() for k, v in e.items()} for e in eng.cache["blocks"]]
    eng.reset_lane(0)
    fresh = t_dec.init_paged_cache(cfg, 1, 4, 4, per_lane_pos=True, device="cpu")
    for entry, init, keep in zip(eng.cache["blocks"], fresh["blocks"], other):
        for k, v in entry.items():
            if k not in ("k_pages", "v_pages"):
                assert torch.equal(v[:, 0], init[k][:, 0]), k
            assert torch.equal(v[:, 1], keep[k]), k
    assert int(eng.cache["pos"][0]) == 0 and int(eng.cache["pos"][1]) == 5
    if arch == "xlstm-1.3b":
        for entry in eng.cache["blocks"]:
            assert bool((entry["m"][:, 0] == -1e30).all())
            assert bool((entry["m"][:, 1] != -1e30).all())


def test_chip_smoke_ssm_lanes_schedule_is_the_lane_phases():
    """PHASE ssm's lane drive, over its cut of the lane trace
    (``SSM_LANE_TRACE``), at each arch's smoke config schedules as the lane
    configuration does on llama3.2-3b over the same cut: a preemption, and
    more requests than lanes, so lanes serve again after a reset."""
    trace = CHIP.SSM_LANE_TRACE
    assert trace["n_steps"] < CHIP.LANE_TRACE["n_steps"]
    want = CHIP.cpu_lane_schedule(trace=trace)
    got = {arch: CHIP.cpu_lane_schedule(arch, trace) for arch in ARCHS}
    assert want["preemptions"] >= 1 and len(want["requests"]) > CHIP.LANE_SERVE["lanes"]
    assert any(r[3] for r in want["requests"])          # a request was preempted
    for arch in ARCHS:
        assert got[arch] == want, arch


# -- gemma2: the sibling ring in a preemption residual -------------------------------

GEMMA = {"gemma2/preempt": ("gemma2-27b", CASES["preempt"]),
         "gemma2/preempt-chunk4": ("gemma2-27b", CASES["preempt-chunk4"])}


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    runs = start_multi_reference(tmp_path_factory.mktemp("gemma_ref"), GEMMA)
    yield runs
    stop_reference(runs)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    return wait_reference(_reference_runs)


@pytest.mark.parametrize("name", list(GEMMA))
def test_gemma2_lane_preempt_resume_matches_reference(name, reference, monkeypatch):
    """gemma2-smoke's two attention positions through a forced preemption,
    streamed and in 4-token chunks: the ``attn_global`` ring's pages travel
    in the residual beside the representative ``attn_local`` ring."""
    monkeypatch.setattr(t_layers.F, "silu", _silu_op_by_op)
    monkeypatch.setattr(t_layers.F, "gelu", _gelu_op_by_op)
    arch, spec = GEMMA[name]
    params = params_from_jax(jax.tree.map(np.asarray, j_tr.init_params(
        j_smoke(arch), jax.random.PRNGKey(0))), device="cpu")
    preempts = []
    preempt = t_engine.ServeEngine.preempt_lane

    def recording(self, lane):
        residual = preempt(self, lane)
        preempts.append(residual)
        return residual
    monkeypatch.setattr(t_engine.ServeEngine, "preempt_lane", recording)
    port = drive(spec, t_registry.get_smoke_config(arch), params, t_engine,
                 t_sched, t_wl, device="cpu",
                 sketch_seeds=sketch_seeds_from_jax(reference["seeds"]))
    _assert_same(port, reference[name])
    assert port["report"]["preemptions"] >= 1 and preempts
    # the representative ring's pages go down to the slow store; the
    # sibling ring's ride in the residual
    assert set(preempts[0]["blocks"][0]) == {"page_len", "cur_slot"}
    assert {"k_pages", "v_pages"} <= set(preempts[0]["blocks"][1])
