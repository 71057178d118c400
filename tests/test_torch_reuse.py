"""The port's content-addressed KV reuse against the reference, on the CPU.

* ``hash_pages`` and ``KVReuseStore`` (``repro_torch.cache``) equal
  ``repro.cache`` on a seeded fuzz of publish / match / release, LRU
  eviction included, in both match modes: every return value, every
  counter, the index, the refcounts and the LRU order.
* ``traffic_bench.py``'s ``kv_reuse`` arm at the llama3.2-3b smoke widths
  (``page_t`` 4, the reuse pool of 32 pages, 8-token chunks, substring
  matching), under the ``none`` and the ``int8`` codec: the reference runs
  in a subprocess with XLA's excess precision off and the ROADMAP C0
  probe pin, the port under ``reference_rounding`` (ROADMAP C2); every
  request's tokens and steps, the scheduler's report, ``reuse_stats``'
  integers, the integer TierStats, the placement tables and the θ traces
  are exactly equal.  The int8 arm is ``chip_smoke.py``'s ``PHASE reuse``
  at smoke width, whose schedule the phase holds the card's run to.
* Preempt and resume of a lane holding shared (refcount > 1) pages, and a
  resume that keeps the shared pages clean (port only, greedy, against the
  port's single-request engine).
"""
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

from repro import cache as j_cache  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch import cache as t_cache  # noqa: E402
from repro_torch import workloads as t_wl  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
BASE_KW = dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
               migration_interval=4, resources=["embeddings"],
               embed_hot_slots=4, embed_rows_per_page=8)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _load_chip_smoke()


def drive(spec, cfg, params, eng_mod, sched_mod, wl_mod, **eng_kw):
    """Run one scenario through an engine/scheduler pair — the reference's
    modules or the port's — and return what the two must agree on, as
    plain JSON values.  ``spec["kind"]`` is "trace" (a seeded trace:
    ``profiles`` None for the kind's own tenants) or "ops" (``submit
    tenant seed n max_new`` and ``run`` lines).  (The reference subprocess
    runs this function's source, so it uses only its arguments and
    numpy.)"""
    import numpy as np
    serve = dict(spec["serve"], resources=tuple(spec["serve"].get("resources", ())))
    eng = eng_mod.ServeEngine(cfg, params, eng_mod.ServeConfig(**serve), **eng_kw)
    if spec["kind"] == "trace":
        kw = dict(spec["trace"])
        if spec["profiles"] is not None:
            kw["tenants"] = tuple(wl_mod.TenantProfile(n, w, r, tuple(p), tuple(o))
                                  for n, w, r, p, o in spec["profiles"])
        trace = wl_mod.make_trace(vocab=cfg.vocab, **kw)
        tenants = [sched_mod.Tenant(t.name, t.weight) for t in trace.tenants]
    else:
        tenants = [sched_mod.Tenant(n, w) for n, w in spec["tenants"]]
    sched = sched_mod.Scheduler(eng, tenants, sched_mod.SchedConfig(**spec["sched"]))
    if spec["kind"] == "trace":
        wl_mod.play(trace, sched)
    else:
        for op in spec["ops"]:
            if op[0] == "submit":
                _, tenant, seed, n, max_new = op
                sched.submit(tenant, np.random.default_rng(seed).integers(
                    0, cfg.vocab, n).astype(np.int32), max_new)
            else:
                sched.run(max_steps=2000)
    rep = sched.report()
    out = {"requests": [
        [r.rid, r.tenant, len(r.prompt), [int(t) for t in r.out],
         r.admitted_step, r.finished_step, r.preemptions,
         [int(s) for s in r.token_steps]]
        for r in sorted(sched.finished, key=lambda r: r.rid)]}
    out["report"] = {k: rep[k] for k in ("steps", "submitted", "completed",
                                         "tokens", "preemptions", "queued_peak",
                                         "mode", "prefill_lanes", "handoff")}
    out["tenants"] = {n: [sched.tenant_stats[n].fast_reads,
                          sched.tenant_stats[n].slow_reads]
                      for n in rep["tenants"]}
    ints = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
            "migration_bytes", "last_epoch_bytes", "max_epoch_bytes",
            "quota_bytes", "migration_epochs", "flush_bytes", "inflight_bytes")
    out["stats"] = {n: {k: int(row[k]) for k in ints}
                    for n, row in eng.tier_stats().items()}
    out["page_slot"] = {n: np.asarray(h.state.tier.page_slot).tolist()
                        for n, h in eng.daemon.resources.items()}
    out["theta"] = {n: [int(t) for t in h.stats.theta_trace]
                    for n, h in eng.daemon.resources.items()}
    stats = eng.reuse_stats()
    out["reuse"] = (None if stats is None else
                    {k: v for k, v in stats.items() if isinstance(v, int)})
    out["refs"] = None if eng.reuse is None else int(sum(eng.reuse.ref.values()))
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


def start_reference(tmp, groups: list[dict], prelude: str = "") -> list:
    """Start one reference subprocess per scenario group, with XLA's excess
    precision off (ROADMAP C2); ``prelude`` is source run before the
    scenarios.  :func:`wait_reference` collects them."""
    script = inspect.getsource(drive) + prelude + _REFERENCE_MAIN
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    runs = []
    for i, group in enumerate(groups):
        spec, out = tmp / f"spec{i}.json", tmp / f"out{i}.json"
        spec.write_text(json.dumps(group))
        runs.append((subprocess.Popen(
            [sys.executable, "-c", script, ARCH, str(spec), str(out)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True), out))
    return runs


def wait_reference(runs) -> dict:
    res = {}
    for proc, out in runs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        res.update(json.loads(out.read_text()))
    return res


def stop_reference(runs) -> None:
    for proc, _ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def port_run(spec, params, seeds):
    return drive(spec, t_registry.get_smoke_config(ARCH), params, t_engine,
                 t_sched, t_wl, device="cpu",
                 sketch_seeds=sketch_seeds_from_jax(seeds))


def _silu_op_by_op(x):
    return x * (1 / (1 + torch.exp(-x)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor runs slow down many-fold when each worker
    also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_rounding(monkeypatch):
    """Round swiglu's activation where the flag-off reference rounds."""
    monkeypatch.setattr(t_layers.F, "silu", _silu_op_by_op)


@pytest.fixture(scope="module")
def port_params():
    return params_from_jax(jax.tree.map(
        np.asarray, j_tr.init_params(j_smoke(ARCH), jax.random.PRNGKey(0))),
        device="cpu")


def _reuse_case(codec):
    return {"kind": "trace", "serve": dict(CHIP.REUSE_SERVE, slow_codec=codec),
            "sched": CHIP.REUSE_SCHED,
            "profiles": [list(p) for p in CHIP.REUSE_TENANTS],
            "trace": CHIP.REUSE_TRACE}


SCENARIOS = {f"kv-reuse-{codec}": _reuse_case(codec) for codec in ("none", "int8")}


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start both arms through the reference as soon as the module's first
    test starts, side by side; :func:`reference` waits for them."""
    runs = start_reference(tmp_path_factory.mktemp("reuse_ref"),
                           [{n: s} for n, s in SCENARIOS.items()])
    yield runs
    stop_reference(runs)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    return wait_reference(_reference_runs)


# -- the store ---------------------------------------------------------------------

@pytest.mark.parametrize("page_t", [1, 4, 16])
def test_hash_pages_matches_reference(page_t):
    rng = np.random.default_rng(page_t)
    for n in (0, page_t - 1, page_t, 5 * page_t + 3, 64):
        toks = rng.integers(0, 128256, n)
        for a, b in zip(t_cache.hash_pages(toks, page_t),
                        j_cache.hash_pages(toks, page_t)):
            assert a.dtype == b.dtype == np.uint64 and np.array_equal(a, b)


def _store_state(s) -> tuple:
    return (dict(s.index), dict(s.ref), dict(s.key_of), list(s.lru),
            list(s.free), s.stats())


@pytest.mark.parametrize("mode", ["prefix", "substring"])
def test_store_matches_reference_fuzz(mode):
    """400 seeded operations over a 12-page pool: streams drawn from a few
    shared prefixes (so pages dedup, hit, and LRU-evict), matches holding
    references, releases (and a double release that must raise in both)."""
    rng = np.random.default_rng(0 if mode == "prefix" else 1)
    page_t = 4
    stores = (t_cache.KVReuseStore(12, base_gid=50, page_t=page_t),
              j_cache.KVReuseStore(12, base_gid=50, page_t=page_t))
    stems = [rng.integers(0, 32, 6 * page_t) for _ in range(4)]
    held: list[list[int]] = []
    for step in range(400):
        op = rng.random()
        stem = stems[int(rng.integers(0, 4))]
        toks = np.concatenate([stem[:int(rng.integers(0, stem.size + 1))],
                               rng.integers(0, 32, int(rng.integers(0, 3 * page_t)))])
        if op < 0.4:
            n_pages = int(rng.integers(0, toks.size // page_t + 2))
            mask = rng.random(toks.size // page_t + 1) < 0.9
            got = [s.publish(toks, n_pages, mask=mask) for s in stores]
            assert got[0] == got[1], step
        elif op < 0.8:
            got = [s.match(toks, mode=mode) for s in stores]
            assert (got[0].pages, got[0].n_matchable) == \
                (got[1].pages, got[1].n_matchable), step
            held.append(list(got[0].pages.values()))
            if rng.random() < 0.3:
                for s in stores:
                    s.note_consumed(len(got[0].pages))
        elif held:
            gids = held.pop(int(rng.integers(0, len(held))))
            for s in stores:
                s.release(gids)
            if gids and rng.random() < 0.1:
                errs = []
                for s in stores:
                    with pytest.raises(ValueError) as e:
                        s.release([gids[0]] * 99)
                    errs.append(str(e.value))
                assert errs[0] == errs[1]
                # the over-release dropped every other holder's reference
                held = [h for h in held if gids[0] not in h]
        assert _store_state(stores[0]) == _store_state(stores[1]), step
    assert stores[0].stats()["evicted"] > 0 and stores[0].stats()["page_hits"] > 0


# -- the kv_reuse arm against the reference ------------------------------------------

# (request id, token index) where the int8 arm's greedy token parts from the
# reference's.  The bf16 K/V the two compute differ by an ulp here and there
# (attention sums its pages in another order: the ulp split
# test_torch_sched.py names), and int8 quantization can turn such an ulp
# into a whole quantum of an installed pool page.  Here it moves request
# 20's last logit row from the reference's top two, 2.734 and 2.547, to a
# tie at 2.688.  A last token is never published, so nothing downstream
# sees it: every other token, step and integer stays equal.
INT8_SPLIT = {(20, 2)}


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_kv_reuse_arm_matches_reference(codec, reference, port_params,
                                        reference_rounding):
    """Tokens (int8: but at INT8_SPLIT), steps, report, reuse counters,
    integer TierStats, placement tables and θ traces exactly equal; the
    reuse pool hit, saved prefill tokens, published, evicted, and its
    references drained."""
    name = f"kv-reuse-{codec}"
    ref = reference[name]
    port = port_run(SCENARIOS[name], port_params, reference["seeds"])
    for key in ref:
        if key != "requests":
            assert port[key] == ref[key], key
    parted = set()
    for got, want in zip(port["requests"], ref["requests"], strict=True):
        assert got[:3] + got[4:] == want[:3] + want[4:], got[0]
        parted |= {(got[0], i) for i, (a, b) in enumerate(zip(got[3], want[3]))
                   if a != b}
    assert parted == (INT8_SPLIT if codec == "int8" else set())
    for rid, i in parted:
        assert i == len(ref["requests"][rid][3]) - 1      # a last token
    reuse = port["reuse"]
    assert reuse["page_hits"] > 0 and reuse["tokens_saved"] > 0
    assert reuse["published"] > 0 and reuse["evicted"] > 0 and port["refs"] == 0
    if codec == "int8":
        for name_, row in port["stats"].items():
            for k in ("migration_bytes", "flush_bytes"):
                assert row[k] % port_row_bytes(name_) == 0, (name_, k)


def port_row_bytes(name):
    """int8 wire bytes of one row of the smoke config's stores: N + 4."""
    cfg = t_registry.get_smoke_config(ARCH)
    n = (cfg.n_groups * CHIP.REUSE_SERVE["page_t"] * cfg.n_kv_heads * 2
         * cfg.head_dim if name == "kv"
         else CHIP.REUSE_SERVE["embed_rows_per_page"] * cfg.d_model)
    return n + 4


def test_chip_smoke_reuse_schedule_matches_reference(reference):
    """``chip_smoke.py``'s PHASE reuse at smoke width: the schedule the
    phase computes on the CPU, to hold the card's run to, equals the
    reference's (steps, each request's admission, finish, preemptions and
    token steps, the reuse counters); the pool's references drained."""
    ref = reference["kv-reuse-int8"]
    got = CHIP.cpu_reuse_schedule()
    assert got == {
        "steps": ref["report"]["steps"],
        "preemptions": ref["report"]["preemptions"],
        "requests": [[rid, adm, fin, pre, steps]
                     for rid, _, _, _, adm, fin, pre, steps in ref["requests"]],
        "reuse": ref["reuse"]}
    assert ref["refs"] == 0
    small, full = (t_wl.make_trace(vocab=v, tenants=tuple(
        t_wl.TenantProfile(*p) for p in CHIP.REUSE_TENANTS), **CHIP.REUSE_TRACE)
        for v in (256, 128256))
    assert [(a.step, a.tenant, a.tokens.size, a.max_new) for a in small.arrivals] \
        == [(a.step, a.tenant, a.tokens.size, a.max_new) for a in full.arrivals]


# -- preemption with shared pages (port only) ------------------------------------------

def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _sched(params, reuse_pages, lanes=1, segments=2, patience=16,
           tenants=(("t", 1.0),)):
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), params, t_engine.ServeConfig(
            **dict(BASE_KW, resources=("embeddings",)), lanes=lanes,
            kv_segments=segments, reuse_pages=reuse_pages), device="cpu")
    return eng, t_sched.Scheduler(eng, [t_sched.Tenant(n, w) for n, w in tenants],
                                  t_sched.SchedConfig(preempt_patience=patience))


def _generate(params):
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), params,
        t_engine.ServeConfig(**dict(BASE_KW, resources=())), device="cpu")
    return lambda prompt, n: list(eng.generate(np.asarray(prompt)[None],
                                               n_tokens=n)[0])


def test_preempt_resume_with_shared_refcount_pages(port_params):
    """A lane holding shared (refcount > 1) pool pages is preempted, the
    lane serves a request referencing the SAME pages, and the first
    resumes bitwise: tokens equal the single-request engine's, and every
    reference comes home."""
    reference = _generate(port_params)
    shared = _prompt(20, 16)
    long_p = np.concatenate([shared, _prompt(21, 4)])
    eng, sched = _sched(port_params, reuse_pages=16, patience=4,
                        tenants=(("long", 1.0), ("short", 4.0)))
    seed_req = sched.submit("long", shared, max_new=4)   # publishes pages
    sched.run(max_steps=200)
    assert eng.reuse.stats()["published"] > 0
    rl = sched.submit("long", long_p, max_new=20)
    for _ in range(10):
        sched.step()
    rs = sched.submit("short", shared, max_new=4)
    saw_shared = False
    for _ in range(400):
        if rs.state == rl.state == "finished":
            break
        saw_shared = saw_shared or any(v > 1 for v in eng.reuse.ref.values())
        sched.step()
    assert rl.preemptions >= 1 and saw_shared
    assert rl.out == reference(long_p, 20)
    assert rs.out == reference(shared, 4) == seed_req.out
    assert sum(eng.reuse.ref.values()) == 0


def test_resume_keeps_shared_pages_clean(port_params):
    """A resumed lane's installed shared pages stay clean: the next flush
    forks nothing and writes nothing."""
    shared = _prompt(30, 16)
    eng, sched = _sched(port_params, reuse_pages=16)
    sched.submit("t", shared, max_new=4)
    sched.run(max_steps=200)
    sched.submit("t", np.concatenate([shared, _prompt(31, 4)]), max_new=8)
    for _ in range(3):                         # admit and install the run
        sched.step()
    assert (eng._lane_pages[0] >= eng.reuse.base_gid).sum() > 0
    eng.resume_lane(0, eng.preempt_lane(0))
    mapped, flushed = eng._lane_pages[0].copy(), dict(eng._kv_flushed)
    flush_bytes = eng.daemon["kv"].stats.flush_bytes
    eng._flush_kv_lanes()
    assert np.array_equal(eng._lane_pages[0], mapped)
    assert dict(eng._kv_flushed) == flushed
    assert eng.daemon["kv"].stats.flush_bytes == flush_bytes
    sched.run(max_steps=400)
    assert sum(eng.reuse.ref.values()) == 0


def test_reuse_needs_lane_mode(port_params):
    with pytest.raises(ValueError, match="lane mode"):
        t_engine.ServeEngine(
            t_registry.get_smoke_config(ARCH), port_params,
            t_engine.ServeConfig(**dict(BASE_KW, resources=()), reuse_pages=4),
            device="cpu")
