"""The port's engine and scheduler on kimi-k2 with the experts resource
against the reference, on the CPU, at the kimi-k2 smoke widths, from the
reference's exact weights (``params_from_jax``) and H3 seeds.

* The reference runs in subprocesses with XLA's excess precision off and
  the ROADMAP C0 probe pin, the port under ``reference_rounding`` (ROADMAP
  C2), through ``tests/test_torch_sched.py``'s ``drive``: single-request
  ``generate`` (serve_bench.py's kimi-k2 case, and a prompt that spans two
  prefill chunks) and the unified scheduler over lanes (streamed and
  chunked prefill, a forced preemption that carries the dense prologue's
  ring in the residual).  Every token and step, the report's integers,
  every resource's integer TierStats (kv, experts, embeddings), every
  placement table and every θ trace are exactly equal.
* ``chip_smoke.py``'s PHASE moe lane drive at smoke width: the reference's
  schedule equals the port's, which the phase holds the card's to.
* A two-tenant mmpp trace at traffic_bench.py's SERVE_KW shape with
  chunked prefill parts from the reference at one step only, a named
  near-tie: there the reference's top two logits are an exact bf16 tie and
  the port's one ulp apart (ROADMAP Queue C); every expert stream and every
  greedy pick before it is equal.
* After a run every promoted expert's fast row equals its slow row
  bitwise; experts on an arch without MoE layers raise the reference's
  ``ValueError``.
"""
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402
from test_torch_sched import (CHIP, ROOT, SERVE_KW, _REFERENCE_MAIN,  # noqa: E402,F401
                              _assert_same, drive, reference_rounding)

ARCH = "kimi-k2-1t-a32b"
MOE = dict(resources=["experts", "embeddings"], expert_hot_slots=2)
# tests/test_sched.py's lane configuration with the experts resource
BASE_KW = dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
               migration_interval=4, embed_hot_slots=4, embed_rows_per_page=8,
               **MOE)


def _ops(lanes, tenants, ops, **sched):
    return {"kind": "ops", "serve": dict(BASE_KW, lanes=lanes, kv_segments=2),
            "tenants": tenants, "ops": ops, "sched": sched}


PREEMPT = [["submit", "long", 3, 8, 24], ["step", 10],
           ["submit", "short", 4, 5, 4], ["run"]]
SCENARIOS = {
    # benchmarks/serve_bench.py's kimi-k2 case: batch 2 of 16-token prompts
    "serve-bench": {
        "kind": "single", "seed": 16, "len": 16, "new": 16,
        "serve": dict(max_seq=256, paged=True, page_t=8, hot_slots=6,
                      migration_interval=4, embed_hot_slots=2, **MOE)},
    # serve_bench.py's overlap shape: a 30-token prompt in two chunks
    "two-chunks": {
        "kind": "single", "seed": 30, "len": 30, "new": 16,
        "serve": dict(max_seq=64, paged=True, page_t=4, hot_slots=6,
                      migration_interval=4, kv_quota=16, embed_hot_slots=2,
                      **MOE)},
    "admission-chunk4": _ops(2, [["a", 1.0]],
                             [["submit", "a", 10 + i, 8, 6] for i in range(5)]
                             + [["step", 1], ["run"]], prefill_chunk=4),
    "preempt": _ops(1, [["long", 1.0], ["short", 4.0]], PREEMPT,
                    preempt_patience=4),
    "preempt-chunk4": _ops(1, [["long", 1.0], ["short", 4.0]], PREEMPT,
                           preempt_patience=4, prefill_chunk=4),
    "chip-moe-lanes": {
        "kind": "trace", "serve": CHIP.MOE_LANES, "sched": CHIP.LANE_SCHED,
        "profiles": [list(p) for p in CHIP.LANE_TENANTS],
        "trace": CHIP.MOE_TRACE},
}
# the near-tie trace: traffic_bench.py's SERVE_KW with experts, 8-token chunks
NEAR_TIE_TRACE = {
    "serve": dict(SERVE_KW, **MOE),
    "sched": dict(preempt_patience=24, prefill_chunk=8),
    "trace": dict(kind="zipf-hot", n_steps=40, seed=0, arrival="mmpp")}
NEAR_TIE = (34, 0)      # (engine call, lane) where the greedy picks part


def drive_logged(spec, cfg, params, eng_mod, sched_mod, wl_mod, **eng_kw):
    """Play ``spec``'s trace through an engine and scheduler (the
    reference's or the port's) and log, in call order, every lane step's
    active mask and logits, every chunk's logits and every experts stream
    the daemon takes.  (The reference subprocess runs this function's
    source, so it uses only its arguments and numpy.)"""
    import numpy as np
    serve = dict(spec["serve"], resources=tuple(spec["serve"]["resources"]))
    eng = eng_mod.ServeEngine(cfg, params, eng_mod.ServeConfig(**serve), **eng_kw)
    log = []
    advance, prefill, observe = (eng.advance_lanes, eng.prefill_lane,
                                 eng.daemon.observe)

    def logged_advance(tokens, active, segments):
        out = advance(tokens, active, segments)
        log.append(["step", np.asarray(active, bool).tolist(),
                    np.asarray(out, np.float32).tolist()])
        return out

    def logged_prefill(lane, tokens, segment, chunk=None):
        out = prefill(lane, tokens, segment, chunk)
        log.append(["chunk", lane, np.asarray(out, np.float32).tolist()])
        return out

    def logged_observe(name, *args, **kw):
        if name == "experts":
            log.append(["experts", np.asarray(args[0]).reshape(-1).tolist()])
        return observe(name, *args, **kw)
    eng.advance_lanes, eng.prefill_lane = logged_advance, logged_prefill
    eng.daemon.observe = logged_observe
    profiles = wl_mod.DEFAULT_TENANTS
    sched = sched_mod.Scheduler(eng, [sched_mod.Tenant(t.name, t.weight)
                                      for t in profiles],
                                sched_mod.SchedConfig(**spec["sched"]))
    wl_mod.play(wl_mod.make_trace(vocab=cfg.vocab, tenants=profiles,
                                  **spec["trace"]), sched)
    return {"log": log}


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
    """Start every scenario through the reference as the module's first test
    starts, in three subprocesses side by side, with XLA's excess precision
    off (ROADMAP C2); :func:`reference` waits for them."""
    tmp = tmp_path_factory.mktemp("moe_ref")
    script = inspect.getsource(drive) + _REFERENCE_MAIN
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    names = list(SCENARIOS)
    runs = []
    for i, group in enumerate(names[i::3] for i in range(3)):
        spec, out = tmp / f"spec{i}.json", tmp / f"out{i}.json"
        spec.write_text(json.dumps({n: SCENARIOS[n] for n in group}))
        runs.append((subprocess.Popen(
            [sys.executable, "-c", script, ARCH, str(spec), str(out)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True), out))
    spec, out = tmp / "spec_tie.json", tmp / "out_tie.json"
    spec.write_text(json.dumps({"near-tie": NEAR_TIE_TRACE}))
    runs.append((subprocess.Popen(
        [sys.executable, "-c", inspect.getsource(drive_logged) + _REFERENCE_MAIN.replace(
            "drive(", "drive_logged("), ARCH, str(spec), str(out)], env=env,
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


def _port_engine(serve, params, seeds):
    serve = dict(serve, resources=tuple(serve["resources"]))
    return t_engine.ServeEngine(t_registry.get_smoke_config(ARCH), params,
                                t_engine.ServeConfig(**serve), device="cpu",
                                sketch_seeds=sketch_seeds_from_jax(seeds))


@pytest.mark.parametrize("name", [n for n in SCENARIOS if n != "chip-moe-lanes"])
def test_engine_and_scheduler_match_reference(name, reference, port_params,
                                              reference_rounding):
    """Tokens and steps, the report's integers and per-tenant reads, every
    resource's tier_stats integers, placement tables and θ traces."""
    ref = reference[name]
    port = drive(SCENARIOS[name], t_registry.get_smoke_config(ARCH), port_params,
                 t_engine, t_sched, t_wl, device="cpu",
                 sketch_seeds=sketch_seeds_from_jax(reference["seeds"]))
    _assert_same(port, ref)
    experts = port["stats"]["experts"]
    assert experts["migration_bytes"] > 0
    assert experts["fast_reads"] > 0 and experts["slow_reads"] > 0
    if name.startswith("preempt"):
        assert port["report"]["preemptions"] >= 1


def test_chip_smoke_moe_lanes_schedule_matches_reference(reference):
    """PHASE moe's lane drive at smoke width: the schedule chip_smoke.py
    computes from the port on the CPU, to hold the card's run to, equals
    the reference's (schedule only, as the lane phase's test explains)."""
    ref = reference["chip-moe-lanes"]
    assert ref["report"]["completed"] == ref["report"]["submitted"]
    assert ref["report"]["preemptions"] >= 1
    assert CHIP.cpu_moe_lane_schedule() == {
        "steps": ref["report"]["steps"],
        "preemptions": ref["report"]["preemptions"],
        "queued_peak": ref["report"]["queued_peak"],
        "requests": [[rid, admitted, finished, n_pre] for rid, _, _, _,
                     admitted, finished, n_pre in ref["requests"]]}


def test_trace_parts_only_at_named_near_tie(reference, port_params,
                                            reference_rounding):
    """Until the named near-tie, every experts stream is equal and every
    lane step's and chunk's greedy pick too, with the live lanes' logits
    within 0.07 (a few bf16 ulps); at it, in lane 0 of engine call 34, the
    reference's top two logits tie exactly (its argmax takes the lower
    token) and the port's are one ulp apart.  The traces part from there."""
    ref = reference["near-tie"]["log"]
    port = drive_logged(NEAR_TIE_TRACE, t_registry.get_smoke_config(ARCH),
                        port_params, t_engine, t_sched, t_wl, device="cpu",
                        sketch_seeds=sketch_seeds_from_jax(reference["seeds"]))["log"]
    calls = 0
    for mine, theirs in zip(port, ref):
        assert mine[0] == theirs[0]
        if mine[0] == "experts":
            assert mine[1] == theirs[1], f"experts stream before call {calls}"
            continue
        a, b = np.atleast_2d(mine[-1]), np.atleast_2d(theirs[-1])
        rows = (np.flatnonzero(mine[1]) if mine[0] == "step" else [0])
        np.testing.assert_allclose(a[rows], b[rows], atol=0.07, rtol=0,
                                   err_msg=f"call {calls}")
        parted = [r for r in rows if a[r].argmax() != b[r].argmax()]
        if parted:
            assert (calls, int(parted[0])) == NEAR_TIE and len(parted) == 1
            lane = parted[0]
            top_ref, top_port = np.sort(b[lane])[-2:], np.sort(a[lane])[-2:]
            assert top_ref[1] == top_ref[0]
            assert top_port[1] - top_port[0] == 2.0 ** (np.floor(np.log2(
                top_port[1])) - 7)
            break
        calls += 1
    else:
        pytest.fail("the traces never parted at the named near-tie")


def test_promoted_expert_rows_equal_their_slow_rows(reference, port_params):
    """What the daemon moved up is byte for byte the slow store's row, and
    the slow store is the bound weights' [w_gate | w_in | w_out] layout."""
    eng = _port_engine(SCENARIOS["two-chunks"]["serve"], port_params,
                       reference["seeds"])
    prompt = np.random.default_rng(30).integers(0, 256, (2, 30))
    eng.generate(prompt, 16)
    h = eng.daemon["experts"]
    slot_page = h.state.tier.slot_page
    resident = torch.nonzero(slot_page >= 0).reshape(-1)
    assert resident.numel() > 0
    buf = h.mem.buffers
    assert torch.equal(buf.fast[resident], buf.slow[slot_page[resident].long()])
    ffn = port_params["blocks"][0]["ffn"]
    g, e = 1, 5
    want = torch.cat([ffn[k][g, e].reshape(-1) for k in ("w_gate", "w_in", "w_out")])
    assert torch.equal(buf.slow[g * 8 + e], want)


def test_experts_on_a_dense_arch_raise_the_references_error():
    arch = "llama3.2-3b"
    with pytest.raises(ValueError) as ref:
        j_engine.ServeEngine(j_smoke(arch), None, j_engine.ServeConfig(
            paged=True, resources=("experts",)))
    with pytest.raises(ValueError) as port:
        t_engine.ServeEngine(t_registry.get_smoke_config(arch), None,
                             t_engine.ServeConfig(paged=True,
                                                  resources=("experts",)),
                             device="cpu")
    assert str(port.value) == str(ref.value)
