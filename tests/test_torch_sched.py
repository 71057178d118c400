"""The port's lane substrate and unified scheduler against the reference, on
the CPU, at the llama3.2-3b smoke widths, from the reference's exact
weights (``params_from_jax``) and H3 seeds.

* Masked decode (float32, in process): ``decode_step_paged`` and
  ``prefill_paged`` with per-lane positions and lane masks against the
  reference's step + ``merge_cache``.  Active lanes' logits within 1e-4 and
  page mass within 1e-5 (summation order only), K/V pages within 1e-5,
  integer leaves bitwise; inactive lanes' leaves bitwise unchanged.
* Engine and scheduler (bf16): the reference runs in a subprocess with
  XLA's excess precision off and the ROADMAP C0 probe pin, the port under
  ``reference_rounding`` (ROADMAP C2, as ``test_torch_serve.py``).  Every
  scenario must match exactly: each request's tokens and steps, the
  report's integers and per-tenant reads, the kv and embeddings
  ``tier_stats`` integers, both placement tables and both θ traces.
* The ``chip_smoke.py`` lane phase's trace and configuration at smoke
  width: the reference's schedule equals the port's, which the phase holds
  the card's schedule to (schedule only: see that test).
* The reference's lifecycle invariants, fuzzed over the unified scheduler.
"""
import functools
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import tiering as j_tm  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402
from repro_torch.tiering import resource as t_resource  # noqa: E402
from repro_torch.tiering import resources as t_resources  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
PAGE_T, SLOTS = 4, 4

# tests/test_sched.py's lane configuration, and traffic_bench.py's SERVE_KW
BASE_KW = dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
               migration_interval=4, resources=["embeddings"],
               embed_hot_slots=4, embed_rows_per_page=8)
SERVE_KW = dict(max_seq=64, paged=True, page_t=4, hot_slots=6,
                migration_interval=4, resources=["embeddings"],
                embed_hot_slots=6, embed_quota=8, embed_rows_per_page=8,
                kv_quota=16, kv_tier_slots=12, kv_mass_threshold=0.01,
                lanes=4, kv_segments=6)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _load_chip_smoke()


def _sched_case(serve, tenants, ops, **sched):
    return {"kind": "ops", "serve": serve, "tenants": tenants, "ops": ops,
            "sched": sched}


def _trace_case(kind, chunk):
    return {"kind": "trace", "serve": SERVE_KW, "profiles": None,
            "sched": dict(preempt_patience=24, prefill_chunk=chunk),
            "trace": dict(kind=kind, n_steps=40, seed=0, arrival="mmpp")}


# the scenarios of tests/test_sched.py (ops: submit tenant seed n max_new |
# step k | run), two mmpp traces at traffic_bench.py's SERVE_KW, streaming
# and chunked, and the single-request engine with the embeddings resource
SCENARIOS = {
    "concurrent": _sched_case(
        dict(BASE_KW, lanes=2, kv_segments=2), [["a", 1.0], ["b", 1.0]],
        [["submit", "a", 1, 8, 8], ["submit", "b", 2, 6, 10], ["run"]]),
    "admission": _sched_case(
        dict(BASE_KW, lanes=2, kv_segments=2), [["a", 1.0]],
        [["submit", "a", 10 + i, 8, 6] for i in range(5)]
        + [["step", 1], ["run"]]),
    "preempt": _sched_case(
        dict(BASE_KW, lanes=1, kv_segments=2),
        [["long", 1.0], ["short", 4.0]],
        [["submit", "long", 3, 8, 24], ["step", 10],
         ["submit", "short", 4, 5, 4], ["run"]], preempt_patience=4),
    **{f"{kind}-chunk{c}": _trace_case(kind, c)
       for kind in ("zipf-hot", "scan-antagonist") for c in (0, 8)},
    "single-embeddings": {
        "kind": "single", "seed": 30, "len": 30, "new": 16,
        "serve": dict(paged=True, page_t=4, hot_slots=6, migration_interval=4,
                      kv_quota=16, max_seq=64, resources=["embeddings"],
                      embed_hot_slots=4, embed_rows_per_page=8,
                      jit_tier_reads=True)},
    # the lane phase's trace at 48 arrival steps, and cut as the phase runs it
    "chip-smoke-lanes": {
        "kind": "trace", "serve": CHIP.LANE_SERVE, "sched": CHIP.LANE_SCHED,
        "profiles": [list(p) for p in CHIP.LANE_TENANTS],
        "trace": dict(CHIP.LANE_TRACE, n_steps=48)},
    "chip-smoke-lanes-cut": {
        "kind": "trace", "serve": CHIP.LANE_SERVE, "sched": CHIP.LANE_SCHED,
        "profiles": [list(p) for p in CHIP.LANE_TENANTS],
        "trace": CHIP.LANE_TRACE},
}
CHIP_LANES = ("chip-smoke-lanes", "chip-smoke-lanes-cut")


def drive(spec, cfg, params, eng_mod, sched_mod, wl_mod, **eng_kw):
    """Run one scenario through an engine/scheduler pair — the reference's
    modules or the port's — and return what the two must agree on, as
    plain JSON values.  (The reference subprocess runs this function's
    source, so it uses only its arguments and numpy.)"""
    import numpy as np
    serve = dict(spec["serve"], resources=tuple(spec["serve"]["resources"]))
    eng = eng_mod.ServeEngine(cfg, params, eng_mod.ServeConfig(**serve),
                              **eng_kw)
    out = {}
    if spec["kind"] == "single":
        prompt = np.random.default_rng(spec["seed"]).integers(
            0, cfg.vocab, (2, spec["len"])).astype(np.int32)
        out["tokens"] = np.asarray(eng.generate(prompt, spec["new"])).tolist()
        out["steps"] = eng.step_count
    else:
        if spec["kind"] == "trace":
            profiles = (tuple(wl_mod.TenantProfile(n, w, r, tuple(p), tuple(o))
                              for n, w, r, p, o in spec["profiles"])
                        if spec["profiles"] else wl_mod.DEFAULT_TENANTS)
            tenants = [sched_mod.Tenant(t.name, t.weight) for t in profiles]
        else:
            tenants = [sched_mod.Tenant(n, w) for n, w in spec["tenants"]]
        sched = sched_mod.Scheduler(eng, tenants,
                                    sched_mod.SchedConfig(**spec["sched"]))
        if spec["kind"] == "trace":
            trace = wl_mod.make_trace(vocab=cfg.vocab, tenants=profiles,
                                      **spec["trace"])
            wl_mod.play(trace, sched)
        else:
            for op in spec["ops"]:
                if op[0] == "submit":
                    _, tenant, seed, n, max_new = op
                    sched.submit(tenant, np.random.default_rng(seed).integers(
                        0, cfg.vocab, n).astype(np.int32), max_new)
                elif op[0] == "step":
                    for _ in range(op[1]):
                        sched.step()
                else:
                    sched.run(max_steps=2000)
        rep = sched.report()
        out["requests"] = [
            [r.rid, r.tenant, len(r.prompt), [int(t) for t in r.out],
             r.admitted_step, r.finished_step, r.preemptions]
            for r in sorted(sched.finished, key=lambda r: r.rid)]
        out["report"] = {k: rep[k] for k in
                         ("steps", "submitted", "completed", "tokens",
                          "preemptions", "queued_peak")}
        out["tenants"] = {
            n: [row["completed"], row["tokens"],
                sched.tenant_stats[n].fast_reads,
                sched.tenant_stats[n].slow_reads]
            for n, row in rep["tenants"].items()}
    ints = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
            "migration_bytes", "last_epoch_bytes", "max_epoch_bytes",
            "quota_bytes", "migration_epochs", "flush_bytes", "inflight_bytes")
    out["stats"] = {n: {k: int(row[k]) for k in ints}
                    for n, row in eng.tier_stats().items()}
    out["page_slot"] = {n: np.asarray(h.state.tier.page_slot).tolist()
                        for n, h in eng.daemon.resources.items()}
    out["theta"] = {n: [int(t) for t in h.stats.theta_trace]
                    for n, h in eng.daemon.resources.items()}
    return out


_REFERENCE_MAIN = """
import json, sys
import numpy as np, jax
import repro.dist.host_offload as ho
ho._probe_cache["kinds"] = ("device",)   # ROADMAP C0
from repro import workloads
from repro.core.sketch import make_seeds
from repro.configs.registry import get_smoke_config
from repro.models import transformer as tr
from repro.serve import engine, sched
cfg = get_smoke_config(sys.argv[1])
params = tr.init_params(cfg, jax.random.PRNGKey(0))
specs = json.loads(open(sys.argv[2]).read())
res = {name: drive(spec, cfg, params, engine, sched, workloads)
       for name, spec in specs.items()}
res["seeds"] = np.asarray(make_seeds(jax.random.PRNGKey(0), 2, 1 << 14)).tolist()
json.dump(res, open(sys.argv[3], "w"))
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor runs slow down many-fold when each worker
    also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start every scenario through the reference as soon as the module's
    first test starts, in four subprocesses side by side, with XLA's excess
    precision off (ROADMAP C2); :func:`reference` waits for them."""
    tmp = tmp_path_factory.mktemp("sched_ref")
    script = inspect.getsource(drive) + _REFERENCE_MAIN
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    names = [n for n in SCENARIOS if n not in CHIP_LANES]
    groups = [[n] for n in CHIP_LANES] + [names[i::3] for i in range(3)]
    runs = []
    for i, group in enumerate(groups):
        spec, out = tmp / f"spec{i}.json", tmp / f"out{i}.json"
        spec.write_text(json.dumps({n: SCENARIOS[n] for n in group}))
        runs.append((subprocess.Popen(
            [sys.executable, "-c", script, ARCH, str(spec), str(out)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True), out))
    yield runs
    for proc, _ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference(_reference_runs):
    res = {}
    for proc, out in _reference_runs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        res.update(json.loads(out.read_text()))
    return res


@pytest.fixture(scope="module")
def jax_params():
    return j_tr.init_params(j_smoke(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")


def _silu_op_by_op(x):
    return x * (1 / (1 + torch.exp(-x)))


@pytest.fixture
def reference_rounding(monkeypatch):
    """Round swiglu's activation where the flag-off reference rounds."""
    monkeypatch.setattr(t_layers.F, "silu", _silu_op_by_op)


def _port_run(spec, params, seeds):
    return drive(spec, t_registry.get_smoke_config(ARCH), params, t_engine,
                 t_sched, t_wl, device="cpu",
                 sketch_seeds=sketch_seeds_from_jax(seeds))


def _assert_same(port, ref):
    for key in ref:
        assert port[key] == ref[key], key


# -- masked decode, float32 ------------------------------------------------------

def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _lane_pair(jax_params, b):
    cfg, tcfg = j_smoke(ARCH), t_registry.get_smoke_config(ARCH)
    jp = _f32(jax_params)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jc = j_dec.init_paged_cache(cfg, b, SLOTS, PAGE_T, dtype=jnp.float32,
                                per_lane_pos=True)
    tc = t_dec.init_paged_cache(tcfg, b, SLOTS, PAGE_T, dtype=torch.float32,
                                per_lane_pos=True, device="cpu")
    return cfg, tcfg, jp, tp, jc, tc


def _leaves(cache):
    ring = cache["blocks"][0]
    return {"pos": cache["pos"], **{k: ring[k] for k in ring}}


def _snapshot(tc):
    return {k: v.clone() for k, v in _leaves(tc).items()}


def _check_lanes(tc, jc, before, act, msg):
    """Integer leaves equal the reference's, pages within 1e-5, and the
    inactive lanes' leaves bitwise what they were."""
    tl, jl = _leaves(tc), _leaves(jc)
    for k in ("pos", "page_len", "cur_slot"):
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]),
                                      err_msg=f"{k} {msg}")
    for k in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), atol=1e-5,
                                   rtol=0, err_msg=f"{k} {msg}")
    idle = torch.as_tensor(~np.asarray(act, bool))
    for k, v in tl.items():
        lane_axis = 0 if k == "pos" else 1
        assert torch.equal(v.index_select(lane_axis, idle.nonzero()[:, 0]),
                           before[k].index_select(lane_axis, idle.nonzero()[:, 0])), \
            f"inactive lane's {k} changed {msg}"


MASKS = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 1], [0, 0, 1],
         [1, 0, 1], [1, 1, 1], [0, 1, 0], [1, 0, 1]] * 2


def test_decode_step_lane_mask_matches_reference_merge(jax_params):
    """20 masked steps over 3 lanes (ragged positions, rings of 4 slots x 4
    tokens wrapping at different steps), mask [1, 0, 1] among them."""
    cfg, tcfg, jp, tp, jc, tc = _lane_pair(jax_params, 3)
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg,
                                      page_t=PAGE_T, return_streams=True))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (len(MASKS), 3, 1))
    for step, mask in enumerate(MASKS):
        act = np.asarray(mask, bool)
        before = _snapshot(tc)
        jl, jn, js = jstep(jp, jc, jnp.asarray(toks[step]))
        jc = j_dec.merge_cache(jc, jn, jnp.asarray(act))
        tl, tc, ts = t_dec.decode_step_paged(
            tcfg, tp, tc, torch.from_numpy(toks[step]), page_t=PAGE_T,
            return_streams=True, active=torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   atol=1e-4, rtol=0, err_msg=f"logits {step}")
        np.testing.assert_allclose(ts["kv_mass"].numpy()[:, :, act],
                                   np.asarray(js["kv_mass"])[:, :, act],
                                   atol=1e-5, rtol=0, err_msg=f"mass {step}")
        _check_lanes(tc, jc, before, act, f"step {step}")


def test_prefill_ragged_valid_one_lane_matches_reference(jax_params):
    """A 6-column chunk for lane 1 only, 4 valid tokens (its ring wraps),
    after 7 masked steps; lanes 0 and 2 frozen."""
    cfg, tcfg, jp, tp, jc, tc = _lane_pair(jax_params, 3)
    rng = np.random.default_rng(4)
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg, page_t=PAGE_T))
    for mask in MASKS[:7]:
        tok = rng.integers(0, cfg.vocab, (3, 1))
        _, jn = jstep(jp, jc, jnp.asarray(tok))
        jc = j_dec.merge_cache(jc, jn, jnp.asarray(mask, bool))
        t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(tok), page_t=PAGE_T,
                                active=torch.as_tensor(mask, dtype=torch.bool))
    toks = rng.integers(0, cfg.vocab, (3, 6))
    valid = np.zeros((3, 6), bool)
    valid[1, :4] = True
    act = np.array([False, True, False])
    before = _snapshot(tc)
    jl, jc, js = j_dec.prefill_paged(cfg, jp, jc, jnp.asarray(toks), page_t=PAGE_T,
                                     valid=jnp.asarray(valid),
                                     active=jnp.asarray(act), collect_mass=True)
    tl, tc, ts = t_dec.prefill_paged(tcfg, tp, tc, torch.from_numpy(toks),
                                     page_t=PAGE_T, valid=valid, active=act,
                                     collect_mass=True)
    np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts["kv_mass"].numpy()[:4, :, :, 1],
                               np.asarray(js["kv_mass"])[:4, :, :, 1],
                               atol=1e-5, rtol=0)
    assert not ts["kv_mass"][4:].any()          # skipped padding columns
    _check_lanes(tc, jc, before, act, "after the chunk")


def _lane_engine(tparams, **kw):
    return t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), tparams,
        t_engine.ServeConfig(**dict(BASE_KW, resources=("embeddings",),
                                    hot_slots=8, lanes=2, kv_segments=2, **kw)),
        device="cpu")


def test_chunked_prefill_equals_streaming_bitwise(port_params):
    """prefill_lane in ragged chunks of 5 against token-at-a-time
    advance_lanes: the same last logits and the same slow-store segment,
    bitwise (bf16)."""
    prompt = np.random.default_rng(9).integers(0, 256, 23).astype(np.int32)
    chunked = _lane_engine(port_params)
    chunked.start_lanes()
    got = chunked.prefill_lane(1, prompt, segment=1, chunk=5)
    stream = _lane_engine(port_params)
    stream.start_lanes()
    toks, segs = np.zeros(2, np.int32), np.array([-1, 1], np.int32)
    for t in prompt:
        toks[1] = t
        want = stream.advance_lanes(toks, np.array([False, True]), segs)[1]
    assert np.array_equal(got, want)
    seg = []
    for eng in (chunked, stream):
        eng._flush_kv_lanes(lanes=[1], force=True)
        seg.append(eng.daemon["kv"].mem.buffers.slow[12:24].clone())
    assert torch.equal(seg[0], seg[1]) and seg[0].abs().sum() > 0
    for k in ("pos", "page_len", "cur_slot", "k_pages", "v_pages"):
        assert torch.equal(_leaves(chunked.cache)[k], _leaves(stream.cache)[k]), k


# -- small pieces ----------------------------------------------------------------

@pytest.mark.parametrize("cap", [1 << 14, 5])
def test_embed_encode_stream_matches_reference(cap):
    """Token ids to vocab row-block pages, -1 pads kept, stride-subsampled
    to the stream cap."""
    toks = np.random.default_rng(5).integers(-1, 256, (3, 7)).astype(np.int32)
    spec_j = j_tm.ResourceSpec("embeddings", n_pages=32, hot_slots=4,
                               stream_cap=cap)
    spec_t = t_resource.ResourceSpec("embeddings", n_pages=32, hot_slots=4,
                                     stream_cap=cap)
    want = j_tm.EmbedRowsResource(spec_j, rows_per_page=8).encode_stream(
        jnp.asarray(toks))
    got = t_resources.EmbedRowsResource(spec_t, rows_per_page=8).encode_stream(
        torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- lifecycle fuzz (the invariants of tests/test_sched.py, unified mode) --------

def _check_invariants(sched, reqs):
    """Every submitted request lives in EXACTLY one scheduler container,
    lanes are single-occupancy, and the KV segment ledger neither leaks nor
    double-books."""
    where: dict[int, str] = {}

    def seen(req, place):
        assert req.rid not in where, \
            f"rid {req.rid} in both {where[req.rid]} and {place}"
        where[req.rid] = place

    for r in sched.queue:
        assert r.state in ("queued", "preempted"), r.state
        seen(r, "queue")
    for ln, r in enumerate(sched.lanes):
        if r is None:
            continue
        assert r.lane == ln, f"lane {ln} holds r.lane={r.lane}"
        assert r.state == "running"
        seen(r, f"lane {ln}")
    for r in sched.finished:
        assert r.state == "finished"
        seen(r, "finished")
    assert set(where) == {r.rid for r in reqs}, "request lost or invented"
    n_seg = sched.eng.scfg.kv_segments or sched.n_lanes
    free = sched.free_segments
    assert len(set(free)) == len(free), "free segment duplicated"
    held = [r.segment for r in reqs if r.state in ("running", "preempted")]
    assert len(set(held)) == len(held), "segment double-booked"
    assert not set(held) & set(free), "held segment also on the free list"
    assert set(held) | set(free) <= set(range(n_seg))


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("seed", [3, 11])
def test_lifecycle_fuzz_seeded(port_params, seed, chunk):
    """A seeded random submit/step script, invariants after every step,
    then drain to quiescence and check nothing leaked."""
    cfg = t_registry.get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    lanes = int(rng.integers(1, 3))
    segments = lanes + int(rng.integers(1, 3))
    eng = t_engine.ServeEngine(cfg, port_params, t_engine.ServeConfig(
        **dict(BASE_KW, resources=("embeddings",)), lanes=lanes,
        kv_segments=segments), device="cpu")
    sched = t_sched.Scheduler(eng, [t_sched.Tenant("a"),
                                    t_sched.Tenant("b", weight=2.0)],
                              t_sched.SchedConfig(
                                  preempt_patience=int(rng.integers(2, 7)),
                                  prefill_chunk=chunk))
    reqs = []
    for _ in range(60):
        if len(reqs) < 8 and rng.random() < 0.35:
            reqs.append(sched.submit(
                "a" if rng.random() < 0.5 else "b",
                rng.integers(0, cfg.vocab, int(rng.integers(2, 14)))
                   .astype(np.int32),
                max_new=int(rng.integers(1, 7))))
        sched.step()
        _check_invariants(sched, reqs)
        if not sched.active and len(reqs) >= 6:
            break
    while sched.active:
        sched.step()
        _check_invariants(sched, reqs)
        assert sched.step_count < 2000, "fuzz episode failed to drain"
    assert all(r.state == "finished" for r in reqs)
    assert all(len(r.out) == r.max_new for r in reqs)
    rep = sched.report()
    assert rep["completed"] == rep["submitted"] == len(reqs)


# -- engine and scheduler against the reference (runs started at module start) --

@pytest.mark.parametrize("name", [n for n in SCENARIOS if n not in CHIP_LANES])
def test_engine_and_scheduler_match_reference(name, reference, port_params,
                                              reference_rounding):
    """Requests (tokens, admitted/finished steps, preemptions), the report's
    integers and per-tenant reads, both resources' tier_stats integers,
    placement tables and θ traces: all equal."""
    ref = reference[name]
    port = _port_run(SCENARIOS[name], port_params, reference["seeds"])
    _assert_same(port, ref)
    assert port["stats"]["embeddings"]["migration_bytes"] > 0
    if name == "preempt":
        assert port["report"]["preemptions"] >= 1
    if "requests" in port:
        assert port["report"]["completed"] == port["report"]["submitted"]


def test_chip_smoke_lanes_schedule_matches_reference(reference):
    """The chip_smoke.py lane phase's trace and configuration at smoke
    width, at 48 arrival steps and at the phase's cut: the schedule
    chip_smoke.py computes from the port on the CPU (at the cut, the one it
    holds the card's run to) equals the reference's.  Tokens
    are not compared here: with 16-token pages the bf16 K/V part by an ulp
    from the first 32-token chunk on, as the reference's interpret-mode
    Pallas kernel sums the softmax page by page and the port's plain
    version in one pass (float32 agrees within 1e-5).  The trace's arrivals
    do not depend on the vocabulary (the content stream is separate), and
    the phase needs a preemption."""
    for name in CHIP_LANES:
        ref = reference[name]
        trace = SCENARIOS[name]["trace"]
        assert ref["report"]["preemptions"] >= 1, name
        assert ref["report"]["completed"] == ref["report"]["submitted"], name
        assert CHIP.cpu_lane_schedule(trace=trace) == {
            "steps": ref["report"]["steps"],
            "preemptions": ref["report"]["preemptions"],
            "queued_peak": ref["report"]["queued_peak"],
            "requests": [[rid, admitted, finished, n_pre] for rid, _, _, _,
                         admitted, finished, n_pre in ref["requests"]]}, name
        small, full = (t_wl.make_trace(vocab=v, tenants=tuple(
            t_wl.TenantProfile(*p) for p in CHIP.LANE_TENANTS), **trace)
            for v in (256, 128256))
        assert [(a.step, a.tenant, a.tokens.size, a.max_new) for a in small.arrivals] \
            == [(a.step, a.tenant, a.tokens.size, a.max_new) for a in full.arrivals]
