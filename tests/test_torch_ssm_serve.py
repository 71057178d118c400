"""The port's engine and scheduler on zamba2-2.7b (Mamba2 blocks and one
shared attention block) and xlstm-1.3b (mLSTM and sLSTM blocks, no
attention) against the reference, on the CPU at the smoke widths, from the
reference's exact weights (``params_from_jax``) and H3 seeds.

* The reference runs in one subprocess with XLA's excess precision off and
  the ROADMAP C0 probe pin, the port under ``reference_rounding`` (ROADMAP
  C2: op-by-op SiLU and sigmoid, which XLA rounds after every op in bf16),
  through ``tests/test_torch_sched.py``'s ``drive``: single-request
  ``generate`` on the dense cache and on the paged ring, and the unified
  scheduler over lanes with a forced preemption (the recurrent states
  travel in the residual; the preempting request takes the reset lane,
  whose states restart from their initial values) and with five requests
  through two lanes (every lane reused).  Every token and step, the
  report's integers, every resource's integer TierStats, every placement
  table and every θ trace are exactly equal.
* ROADMAP P1: the representative ring is zamba2's ``shared_attn`` position
  and xlstm has none; xlstm's kv resource is registered on the paged
  engine and never observed (zero reads, zero bytes).
* A preempted lane's recurrent states and rings come back bitwise, and the
  resumed request decodes as if it had never left; ``reuse_pages`` is
  refused on both archs with the reference's error.
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
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402
from test_torch_reuse import stop_reference, wait_reference  # noqa: E402
from test_torch_sched import ROOT, _assert_same, _silu_op_by_op, drive  # noqa: E402

ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
# tests/test_sched.py's lane configuration
BASE_KW = dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
               migration_interval=4, resources=["embeddings"],
               embed_hot_slots=4, embed_rows_per_page=8)
SINGLE_KW = dict(max_seq=64, migration_interval=4, resources=["embeddings"],
                 embed_hot_slots=4, embed_rows_per_page=8)
PREEMPT = [["submit", "long", 3, 8, 24], ["step", 10],
           ["submit", "short", 4, 5, 4], ["run"]]


def _single(paged):
    serve = dict(SINGLE_KW, paged=True, page_t=4, hot_slots=6, kv_quota=16) \
        if paged else SINGLE_KW
    return {"kind": "single", "seed": 30, "len": 30, "new": 16, "serve": serve}


def _ops(lanes, tenants, ops, **sched):
    return {"kind": "ops", "serve": dict(BASE_KW, lanes=lanes, kv_segments=2),
            "tenants": tenants, "ops": ops, "sched": sched}


CASES = {
    "dense": _single(False),
    "paged": _single(True),
    "preempt": _ops(1, [["long", 1.0], ["short", 4.0]], PREEMPT,
                    preempt_patience=4),
    "preempt-chunk4": _ops(1, [["long", 1.0], ["short", 4.0]], PREEMPT,
                           preempt_patience=4, prefill_chunk=4),
    "admission-chunk4": _ops(2, [["a", 1.0]],
                             [["submit", "a", 10 + i, 8, 6] for i in range(5)]
                             + [["step", 1], ["run"]], prefill_chunk=4),
}
# (arch, case): zamba2 takes the chunked preemption (a chunk of the ring's
# sibling recurrent states under the lane mask), xlstm the streamed one and
# the two-lane reuse
SCENARIOS = {f"{arch}/{case}": (arch, CASES[case]) for arch, case in (
    ("zamba2-2.7b", "dense"), ("zamba2-2.7b", "paged"),
    ("zamba2-2.7b", "preempt-chunk4"),
    ("xlstm-1.3b", "dense"), ("xlstm-1.3b", "paged"), ("xlstm-1.3b", "preempt"),
    ("xlstm-1.3b", "admission-chunk4"))}

# one subprocess, the scenarios of several archs: {name: [arch, spec]}
MULTI_MAIN = """
import json, sys
import numpy as np, jax
import repro.dist.host_offload as ho
ho._probe_cache["kinds"] = ("device",)   # ROADMAP C0
from repro import workloads
from repro.core.sketch import make_seeds
from repro.configs.registry import get_smoke_config
from repro.models import transformer as tr
from repro.serve import engine, sched
res, params = {}, {}
for name, (arch, spec) in json.loads(open(sys.argv[1]).read()).items():
    cfg = get_smoke_config(arch)
    if arch not in params:
        params[arch] = tr.init_params(cfg, jax.random.PRNGKey(0))
    res[name] = drive(spec, cfg, params[arch], engine, sched, workloads)
res["seeds"] = np.asarray(make_seeds(jax.random.PRNGKey(0), 2, 1 << 14)).tolist()
json.dump(res, open(sys.argv[2], "w"))
"""


def start_multi_reference(tmp, scenarios: dict) -> list:
    """Start one reference subprocess over ``scenarios`` ({name: (arch,
    spec)}) with XLA's excess precision off (ROADMAP C2); ``wait_reference``
    collects it."""
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    spec, out = tmp / "spec.json", tmp / "out.json"
    spec.write_text(json.dumps(scenarios))
    script = inspect.getsource(drive) + MULTI_MAIN
    return [(subprocess.Popen(
        [sys.executable, "-c", script, str(spec), str(out)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True), out)]


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
    starts; :func:`reference` waits for it."""
    runs = start_multi_reference(tmp_path_factory.mktemp("ssm_ref"), SCENARIOS)
    yield runs
    stop_reference(runs)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    return wait_reference(_reference_runs)


@pytest.fixture(scope="module")
def port_params():
    return {arch: params_from_jax(jax.tree.map(
        np.asarray, j_tr.init_params(j_smoke(arch), jax.random.PRNGKey(0))),
        device="cpu") for arch in ARCHS}


def _op_by_op_sigmoid(x):
    return 1 / (1 + torch.exp(-x))


@pytest.fixture
def reference_rounding(monkeypatch):
    """Round SiLU and sigmoid where the flag-off reference rounds: after
    every op, in bf16 (mLSTM's output gate and sLSTM's are bf16 sigmoids)."""
    monkeypatch.setattr(t_layers.F, "silu", _silu_op_by_op)
    monkeypatch.setattr(torch, "sigmoid", _op_by_op_sigmoid)


def _port_engine(arch, params, serve, seeds=None):
    serve = dict(serve, resources=tuple(serve.get("resources", ())))
    return t_engine.ServeEngine(
        t_registry.get_smoke_config(arch), params, t_engine.ServeConfig(**serve),
        device="cpu",
        sketch_seeds=None if seeds is None else sketch_seeds_from_jax(seeds))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_entry_is_the_first_ring_or_none(arch, port_params):
    """ROADMAP P1: the representative ring is the first pattern position
    with one (zamba2-smoke's position 2, ``shared_attn``), or None on an
    arch without attention; the ring view and the kv streams follow."""
    eng = _port_engine(arch, port_params[arch], dict(BASE_KW, lanes=2))
    eng.start_lanes()
    entry = eng._paged_entry()
    if arch == "zamba2-2.7b":
        assert entry is eng.cache["blocks"][2] and "page_len" in entry
        assert eng._kv_lane_stream() is not None
    else:
        assert entry is None
        assert eng._ring_view() is None and eng._kv_lane_stream() is None
        assert eng._kv_page_stream() is None


@pytest.mark.parametrize("arch", ARCHS)
def test_reuse_refusal_matches_reference(arch):
    """Neither arch is reuse-eligible (recurrent states are not in the KV
    store): both engines refuse ``reuse_pages`` with the same error."""
    kw = dict(BASE_KW, lanes=2, reuse_pages=8)
    kw["resources"] = tuple(kw["resources"])
    with pytest.raises(ValueError) as ref:
        j_engine.ServeEngine(j_smoke(arch), None, j_engine.ServeConfig(**kw))
    with pytest.raises(ValueError) as port:
        t_engine.ServeEngine(t_registry.get_smoke_config(arch), None,
                             t_engine.ServeConfig(**kw), device="cpu")
    assert str(port.value) == str(ref.value)
    assert "not reuse-eligible" in str(port.value)


def _states(cache, lane):
    """A lane's recurrent states and ring leaves, cloned."""
    return [{k: v[:, lane].clone() for k, v in entry.items()}
            for entry in cache["blocks"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_lane_resumes_bitwise(arch, port_params):
    """Preempt a decoding lane, serve another request in it, resume: every
    recurrent state, ring bookkeeping leaf and live ring row of the lane is
    bitwise what it was, and the request decodes on exactly as in a twin
    engine that never preempted it."""
    params = port_params[arch]
    serve = dict(BASE_KW, lanes=2, kv_segments=3)
    engines = [_port_engine(arch, params, serve) for _ in range(2)]
    prompt = np.random.default_rng(5).integers(0, 256, 9)
    other = np.random.default_rng(6).integers(0, 256, 7)
    act, segs = np.array([True, False]), np.array([0, -1])
    toks = []
    for eng in engines:
        eng.start_lanes()
        nxt = int(np.argmax(eng.prefill_lane(0, prompt, 0, chunk=4)))
        for _ in range(5):
            nxt = int(np.argmax(eng.advance_lanes([nxt, 0], act, segs)[0]))
        toks.append(nxt)
    eng = engines[0]
    before = _states(eng.cache, 0)
    residual = eng.preempt_lane(0)
    eng.reset_lane(0)
    eng.prefill_lane(0, other, 1, chunk=4)
    eng.advance_lanes([3, 0], act, np.array([1, -1]))
    eng.reset_lane(0)
    eng.resume_lane(0, residual)
    after = _states(eng.cache, 0)
    ring = eng._paged_entry()
    for i, (a, b) in enumerate(zip(after, before)):
        for k in b:
            if engines[0].cache["blocks"][i] is ring and k in ("k_pages", "v_pages"):
                live = b["page_len"] > 0            # (G, S): rows the ring holds
                for g, s in zip(*torch.nonzero(live, as_tuple=True)):
                    n = int(b["page_len"][g, s])
                    assert torch.equal(a[k][g, s, :n], b[k][g, s, :n]), (i, k)
            else:
                assert torch.equal(a[k], b[k]), (i, k)
    outs = []
    for eng, nxt in zip(engines, toks):
        run = []
        for _ in range(6):
            nxt = int(np.argmax(eng.advance_lanes([nxt, 0], act, segs)[0]))
            run.append(nxt)
        outs.append(run)
    assert outs[0] == outs[1]


# -- against the reference (its run started at the module's first test) -------

@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_and_scheduler_match_reference(name, reference, port_params,
                                              reference_rounding):
    """Tokens and steps, the report's integers and per-tenant reads, every
    resource's tier_stats integers, placement tables and θ traces."""
    arch, spec = SCENARIOS[name]
    port = drive(spec, t_registry.get_smoke_config(arch), port_params[arch],
                 t_engine, t_sched, t_wl, device="cpu",
                 sketch_seeds=sketch_seeds_from_jax(reference["seeds"]))
    _assert_same(port, reference[name])
    assert port["stats"]["embeddings"]["migration_bytes"] > 0
    if spec["kind"] == "ops":
        assert port["report"]["completed"] == port["report"]["submitted"]
        if "preempt" in name:
            assert port["report"]["preemptions"] >= 1
    if spec["serve"].get("paged"):
        kv = port["stats"]["kv"]
        if arch == "xlstm-1.3b":     # registered, never observed (ROADMAP P1)
            assert set(v for k, v in kv.items() if k != "quota_bytes") == {0}, kv
        else:
            assert kv["flush_bytes"] > 0
