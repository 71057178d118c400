"""The port's engine and scheduler on deepseek-v3 (MLA attention, the dense
prologue, the experts resource) against the reference, on the CPU, at the
deepseek-v3 smoke widths, from the reference's exact weights
(``params_from_jax``) and H3 seeds.

* The reference runs in subprocesses with XLA's excess precision off and
  the ROADMAP C0 probe pin, the port under ``reference_rounding`` (ROADMAP
  C2), through ``tests/test_torch_sched.py``'s ``drive``: single-request
  ``generate`` with the kv, experts and embeddings resources
  (serve_bench.py's kimi-k2 case shape, and a prompt over two prefill
  chunks), the unified scheduler over lanes (chunked admission, a forced
  preemption whose residual carries the prologue's rings and whose resume
  reads the [K | V] latent rows back), the same preemption with every slow
  store int8, and disaggregated prefill (a prefill worker hands its lanes'
  latent rows to the decode engine).  Every token and step, the report's
  integers, every resource's integer TierStats, every placement table and
  every θ trace are exactly equal.
* ``chip_smoke.py``'s PHASE mla lane drive at smoke width: the reference's
  schedule equals the port's, which the phase holds the card's to.
* The kv resource's row at deepseek-v3's full width is the reference's,
  (G, page_t, 1, 576 + 512), and the int8 and fp32 codecs encode such rows
  bitwise as the reference does; KV reuse is refused with the reference's
  error.
"""
import inspect
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.dist.host_offload as ho  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.tiering import codec as j_codec  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402
from repro_torch.tiering import codec as t_codec  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402
from test_torch_sched import (CHIP, ROOT, _REFERENCE_MAIN, _assert_same,  # noqa: E402
                              drive, reference_rounding)  # noqa: F401

ARCH = "deepseek-v3-671b"
MOE = dict(resources=["experts", "embeddings"], expert_hot_slots=2)
BASE_KW = dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
               migration_interval=4, embed_hot_slots=4, embed_rows_per_page=8,
               **MOE)


def _ops(lanes, tenants, ops, serve=None, **sched):
    return {"kind": "ops",
            "serve": {**BASE_KW, "lanes": lanes, "kv_segments": 2, **(serve or {})},
            "tenants": tenants, "ops": ops, "sched": sched}


PREEMPT = [["submit", "long", 3, 8, 24], ["step", 10],
           ["submit", "short", 4, 5, 4], ["run"]]
_WORK = [["submit", "a", 1, 18, 5], ["submit", "b", 2, 6, 6],
         ["submit", "a", 3, 11, 4], ["submit", "b", 4, 9, 3], ["run"]]
SCENARIOS = {
    # benchmarks/serve_bench.py's kimi-k2 case shape: batch 2 of 16-token prompts
    "serve-bench": {
        "kind": "single", "seed": 16, "len": 16, "new": 16,
        "serve": dict(max_seq=256, paged=True, page_t=8, hot_slots=6,
                      migration_interval=4, embed_hot_slots=2, **MOE)},
    "two-chunks": {
        "kind": "single", "seed": 30, "len": 30, "new": 16,
        "serve": dict(max_seq=64, paged=True, page_t=4, hot_slots=6,
                      migration_interval=4, kv_quota=16, embed_hot_slots=2,
                      **MOE)},
    "admission-chunk4": _ops(2, [["a", 1.0]],
                             [["submit", "a", 10 + i, 8, 6] for i in range(5)]
                             + [["step", 1], ["run"]], prefill_chunk=4),
    "preempt-chunk4": _ops(1, [["long", 1.0], ["short", 4.0]], PREEMPT,
                           preempt_patience=4, prefill_chunk=4),
    "preempt-int8": _ops(1, [["long", 1.0], ["short", 4.0]], PREEMPT,
                         serve=dict(slow_codec="int8"), preempt_patience=4),
    "disagg": _ops(2, [["a", 1.0], ["b", 1.0]], _WORK, serve=dict(kv_segments=5),
                   preempt_patience=16, prefill_chunk=4, prefill_lanes=1, seed=7),
    "chip-mla-lanes": {
        "kind": "trace", "serve": CHIP.MLA_LANES, "sched": CHIP.LANE_SCHED,
        "profiles": [list(p) for p in CHIP.LANE_TENANTS],
        "trace": CHIP.MOE_TRACE},
}


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
    tmp = tmp_path_factory.mktemp("mla_ref")
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
def port_params():
    from repro.models import transformer as j_tr
    from repro_torch.convert import params_from_jax
    jp = j_tr.init_params(j_smoke(ARCH), jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", [n for n in SCENARIOS if n != "chip-mla-lanes"])
def test_engine_and_scheduler_match_reference(name, reference, port_params,
                                              reference_rounding):
    """Tokens and steps, the report's integers and per-tenant reads, every
    resource's tier_stats integers, placement tables and θ traces."""
    from repro_torch.convert import sketch_seeds_from_jax
    port = drive(SCENARIOS[name], t_registry.get_smoke_config(ARCH), port_params,
                 t_engine, t_sched, t_wl, device="cpu",
                 sketch_seeds=sketch_seeds_from_jax(reference["seeds"]))
    _assert_same(port, reference[name])
    experts, kv = port["stats"]["experts"], port["stats"]["kv"]
    assert experts["migration_bytes"] > 0 and kv["flush_bytes"] > 0
    if name.startswith("preempt"):
        assert port["report"]["preemptions"] >= 1


def test_chip_smoke_mla_lanes_schedule_matches_reference(reference):
    """PHASE mla's lane drive at smoke width: the schedule chip_smoke.py
    computes from the port on the CPU, to hold the card's run to, equals
    the reference's (schedule only, as the lane phase's test explains)."""
    ref = reference["chip-mla-lanes"]
    assert ref["report"]["completed"] == ref["report"]["submitted"]
    assert ref["report"]["preemptions"] >= 1
    assert CHIP.cpu_moe_lane_schedule("mla") == {
        "steps": ref["report"]["steps"],
        "preemptions": ref["report"]["preemptions"],
        "queued_peak": ref["report"]["queued_peak"],
        "requests": [[rid, admitted, finished, n_pre] for rid, _, _, _,
                     admitted, finished, n_pre in ref["requests"]]}


def test_kv_row_is_the_references_at_full_width():
    """The [K | V] row of one logical page and its split: (G, page_t, 1,
    576 + 512) on deepseek-v3 at the reference's widths, and the port's
    hand-off and resume split it at 576, as the reference does."""
    for page_t in (8, 64):
        t_eng = types.SimpleNamespace(cfg=t_registry.get_config(ARCH),
                                      scfg=t_engine.ServeConfig(page_t=page_t))
        j_eng = types.SimpleNamespace(cfg=j_get_config(ARCH),
                                      scfg=j_engine.ServeConfig(page_t=page_t))
        assert t_engine.ServeEngine._kv_row_shape(t_eng) == \
            j_engine.ServeEngine._kv_row_shape(j_eng) == (58, page_t, 1, 1088)
        assert t_engine.ServeEngine._kv_split_width(t_eng) == \
            j_engine.ServeEngine._kv_split_width(j_eng) == 576


@pytest.mark.parametrize("codec,jitted", [("int8", False), ("int8", True),
                                          ("fp32", False)])
def test_codecs_on_full_width_latent_rows(codec, jitted, monkeypatch):
    """int8 payloads and per-row scales (fp32 payloads) of 1088-wide
    [K | V] latent rows (two pages of 64 tokens, one layer group) bitwise
    the reference's, in its eager (bind) and jitted (write verb) forms, and
    their decode."""
    monkeypatch.setitem(ho._probe_cache, "kinds", ("device",))
    rng = np.random.default_rng(18)
    rows = rng.normal(size=(2, 1, 64, 1, 1088)).astype(np.float32)
    rows[..., 576:] *= 4.0                       # the latent beside the rope key
    j_rows = jnp.asarray(rows, jnp.bfloat16)
    t_rows = torch.from_numpy(np.asarray(j_rows, np.float32)).to(torch.bfloat16)
    encode = lambda r: j_codec.encode_rows(codec, r)  # noqa: E731
    jq, js = (jax.jit(encode) if jitted else encode)(j_rows)
    tq, ts = t_codec.encode_rows(codec, t_rows, by_reciprocal=jitted)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (ts is None) == (js is None) == (codec == "fp32")
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        t_codec.decode_rows(tq, ts, torch.bfloat16).float().numpy(),
        np.asarray(j_codec.decode_rows(jq, js, jnp.bfloat16), np.float32))


def test_reuse_is_refused_as_the_reference_refuses_it():
    """deepseek-v3 has a dense prologue, so a lane's KV slow store does not
    carry its whole state: both engines refuse KV reuse, in the same words."""
    with pytest.raises(ValueError) as ref:
        j_engine.ServeEngine(j_smoke(ARCH), None, j_engine.ServeConfig(
            paged=True, lanes=2, reuse_pages=8))
    with pytest.raises(ValueError) as port:
        t_engine.ServeEngine(t_registry.get_smoke_config(ARCH), None,
                             t_engine.ServeConfig(paged=True, lanes=2,
                                                  reuse_pages=8), device="cpu")
    assert str(port.value) == str(ref.value)
    assert "not reuse-eligible" in str(port.value)
