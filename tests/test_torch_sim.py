"""The port's tiering simulator against the reference, on the CPU.

* The eight ``WORKLOADS`` generators give the reference's arrays exactly,
  and the five baseline profilers (``repro_torch.core.baselines``) the
  reference's ``observe`` / ``epoch_end`` outputs and overheads exactly on
  one seeded stream.
* ``core.tiering.migrate_data`` is bitwise the reference's, duplicate and
  no-op lanes included.
* ``core.sketch.key_seeds`` equals ``jax.random.randint(PRNGKey(seed),
  (2, 30), 0, W)`` for W = 2**12, 2**14 and 2**19, and ``prng.split``
  equals ``jax.random.split``.
* ``run_sim`` on the CPU against the reference's for all seven methods on
  gups (2,048 pages, blocks of 1,024, 40 blocks, W = 2**12, quota 64,
  Algorithm 1 every 4 blocks, a clear every 16) and for neomem on xsbench
  and btree, with default seeds: hits, promotions, ping-pong and the θ and
  error traces exactly, the modeled runtime within 1e-12 relative (Python
  float arithmetic on the same integers) and the bandwidth trace within
  1e-6 (a float32 ratio read off the device).
* ``chip_smoke.py``'s PHASE sim grid (8 workloads x 6 methods at
  ``benchmarks/common.py``'s scale), cut to 16 blocks: ``cpu_sim_grid``,
  which the phase holds the card's run to, equals the reference's grid
  under the same tolerances.
* The reference's three simulator tests of ``tests/test_neomem_system.py``
  at their sizes, on the port alone.

The reference's runs go to two subprocesses started with the module's
first test (its jitted ``promote`` compiles per batch size); the
in-process tests run meanwhile.
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
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as j_base  # noqa: E402
from repro.core import simulator as j_sim  # noqa: E402
from repro.core.sketch import make_seeds  # noqa: E402
from repro.core.tiering import migrate_data as j_migrate_data  # noqa: E402
from repro_torch.core import baselines as t_base  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402
from repro_torch.core.sketch import key_seeds  # noqa: E402
from repro_torch.core.tiering import migrate_data as t_migrate_data  # noqa: E402
from repro_torch.models import prng  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RUNTIME_RTOL, BW_ATOL = 1e-12, 1e-6


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _load_chip_smoke()

# tests/test_neomem_system.py::test_profiling_overhead_negligible's stream and
# sizes, with Algorithm 1 every 4 blocks and a clear every 16
PARITY_STREAM = dict(n_pages=2048, block=1024, n_blocks=40, seed=5)
PARITY_KW = dict(quota_pages=64, sketch_width=1 << 12, threshold_update_period=4,
                 clear_interval=16)
FIXED_THETA = 4                        # neomem-fixed's threshold
METHODS = ("neomem", "neomem-fixed", "pte-scan", "pebs", "autonuma", "tpp",
           "first-touch")
PARITY = {f"gups-{m}": ("gups", m) for m in METHODS}
PARITY.update({f"{wl}-neomem": (wl, "neomem") for wl in ("xsbench", "btree")})
GRID_BLOCKS = 16


def _parity_kw(method):
    return dict(PARITY_KW, fixed_theta=FIXED_THETA if method == "neomem-fixed" else None)


def _cases():
    parity = {name: {"workload": wl, "method": m, "stream": PARITY_STREAM,
                     "kw": _parity_kw(m)} for name, (wl, m) in PARITY.items()}
    grid = {f"grid/{wl}/{m}": {"workload": wl, "method": m,
                               "stream": dict(CHIP.SIM_STREAM, n_blocks=GRID_BLOCKS),
                               "kw": CHIP.SIM_KW}
            for wl in CHIP.SIM_WORKLOADS for m in CHIP.SIM_METHODS}
    return parity, grid


def _reference_case(case, sim, outcome):
    """One run of ``sim`` (the reference's simulator module or the port's)
    as :func:`chip_smoke.sim_outcome` values.  (The reference subprocess
    runs this function's source, so it uses only its arguments.)"""
    stream = case["stream"]
    res = sim.run_sim(case["method"], sim.WORKLOADS[case["workload"]](**stream),
                      n_pages=stream["n_pages"], collect_trace=True, **case["kw"])
    return outcome(res)


_REFERENCE_MAIN = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
chip = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip)
from repro.core import simulator
cases = json.loads(open(sys.argv[2]).read())
json.dump({name: _reference_case(case, simulator, chip.sim_outcome)
           for name, case in cases.items()}, open(sys.argv[3], "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_runs(tmp_path_factory):
    """Start the reference's runs as the module's first test starts, in two
    subprocesses side by side; :func:`reference` waits for them."""
    tmp = tmp_path_factory.mktemp("sim_ref")
    script = inspect.getsource(_reference_case) + _REFERENCE_MAIN
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    runs = []
    for i, group in enumerate(_cases()):
        spec, out = tmp / f"spec{i}.json", tmp / f"out{i}.json"
        spec.write_text(json.dumps(group))
        runs.append((subprocess.Popen(
            [sys.executable, "-c", script, str(ROOT / "chip_smoke.py"), str(spec),
             str(out)], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True), out))
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


def _assert_outcome(port, ref, what):
    for k in ("fast_hits", "slow_hits", "promoted", "ping_pong", "theta", "err"):
        assert port[k] == ref[k], f"{what}: {k}"
    assert abs(port["runtime"] - ref["runtime"]) <= RUNTIME_RTOL * ref["runtime"], what
    np.testing.assert_allclose(port["bw"], ref["bw"], rtol=0, atol=BW_ATOL,
                               err_msg=what)


# -- generators, baselines, migrate_data, seeds (in process) -----------------------

@pytest.mark.parametrize("name", list(j_sim.WORKLOADS))
def test_workload_streams_match_reference(name):
    kw = dict(n_pages=2048, block=512, n_blocks=18, seed=3)
    ref = list(j_sim.WORKLOADS[name](**kw))
    port = list(t_sim.WORKLOADS[name](**kw))
    assert len(port) == len(ref) == kw["n_blocks"]
    for a, r in zip(port, ref):
        assert a.dtype == r.dtype and np.array_equal(a, r), name


def test_gups_hotset_shift_matches_reference():
    kw = dict(n_pages=4096, block=256, n_blocks=12, seed=4, shift_at=6)
    for a, r in zip(t_sim.gups(**kw), j_sim.gups(**kw)):
        assert np.array_equal(a, r)


_BASELINES = {
    "first-touch": lambda mod, n, s: mod.FirstTouch(n, s, costs=mod.BaselineCosts()),
    "pte-scan": lambda mod, n, s: mod.PteScan(n, s, costs=mod.BaselineCosts()),
    "pebs": lambda mod, n, s: mod.PebsSampler(n, s, costs=mod.BaselineCosts()),
    "autonuma": lambda mod, n, s: mod.HintFault(n, s, promote_after=1,
                                                costs=mod.BaselineCosts()),
    "tpp": lambda mod, n, s: mod.HintFault(n, s, promote_after=2,
                                           costs=mod.BaselineCosts()),
}


@pytest.mark.parametrize("name", list(_BASELINES))
def test_baseline_outputs_match_reference(name):
    """Every observe and epoch_end output (values and dtype) and the final
    overhead equal the reference's over 64 blocks of a seeded gups stream,
    an epoch every 8 blocks as run_sim runs them."""
    n_pages, n_slots = 2048, 682
    port = _BASELINES[name](t_base, n_pages, n_slots)
    ref = _BASELINES[name](j_base, n_pages, n_slots)
    emitted = 0
    for b, pages in enumerate(j_sim.gups(n_pages, 4096, 64, seed=1)):
        outs = [(port.observe(pages), ref.observe(pages))]
        if (b + 1) % 8 == 0:
            outs.append((port.epoch_end(), ref.epoch_end()))
        for a, r in outs:
            if r is None:
                assert a is None
                continue
            assert a.dtype == r.dtype and np.array_equal(a, r), (name, b)
            emitted += r.size
    assert port.overhead == ref.overhead
    if name != "first-touch":
        assert emitted > 0, "the stream never made a page hot"


def _migrate_case(seed, dtype):
    rng = np.random.default_rng(seed)
    n_slots, n_pages, k = 8, 40, 6
    fast = rng.integers(-1000, 1000, (n_slots, 3, 2)).astype(dtype)
    slow = rng.integers(-1000, 1000, (n_pages, 3, 2)).astype(dtype)
    promoted = rng.integers(-1, n_pages, k)
    victims = rng.integers(-1, n_slots, k)
    return fast, slow, promoted.astype(np.int32), victims.astype(np.int32)


_MIGRATE = {f"seed{s}-{np.dtype(d).name}": (s, d) for s in range(6)
            for d in (np.float32, np.int32)}


@pytest.mark.parametrize("case", [*_MIGRATE, "slot0-then-noop", "noop-then-slot0"])
def test_migrate_data_bitwise(case):
    if case in _MIGRATE:
        fast, slow, promoted, victims = _migrate_case(*_MIGRATE[case])
    else:
        fast = np.zeros((4, 2), np.float32)
        slow = np.arange(20, dtype=np.float32).reshape(10, 2) + 1
        promoted, victims = (np.array([3, -1], np.int32), np.array([0, -1], np.int32))
        if case == "noop-then-slot0":
            promoted, victims = promoted[::-1].copy(), victims[::-1].copy()
    rf, rs = j_migrate_data(jnp.asarray(fast), jnp.asarray(slow),
                            jnp.asarray(promoted), jnp.asarray(victims))
    tf, ts = t_migrate_data(torch.from_numpy(fast), torch.from_numpy(slow),
                            torch.from_numpy(promoted), torch.from_numpy(victims))
    assert np.array_equal(tf.numpy(), np.asarray(rf)), case
    assert np.array_equal(ts.numpy(), np.asarray(rs)), case


@pytest.mark.parametrize("width", [1 << 12, 1 << 14, 1 << 19])
@pytest.mark.parametrize("seed", [0, 7])
def test_key_seeds_equal_jax_randint(width, seed):
    ref = np.asarray(make_seeds(jax.random.PRNGKey(seed), 2, width))
    port = key_seeds(2, width, seed)
    assert port.dtype == torch.int32 and np.array_equal(port.numpy(), ref)


@pytest.mark.parametrize("seed,num", [(0, 2), (1, 3), (12345, 5), (-7, 1)])
def test_prng_split_bitwise(seed, num):
    ref = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed), num)))
    assert np.array_equal(prng.split(prng.prng_key(seed), num).numpy(),
                          ref.astype(np.int64))


def test_run_sim_runs_on_the_card_unless_asked():
    assert inspect.signature(t_sim.run_sim).parameters["device"].default == "cuda"


# -- port-only: the reference's simulator claims (tests/test_neomem_system.py) --

def test_neomem_beats_baselines_on_gups():
    """Paper Fig. 11 (scaled): NeoMem >= every baseline on skewed GUPS."""
    res = {}
    for method in ["neomem", "first-touch", "pte-scan", "pebs", "tpp"]:
        stream = t_sim.WORKLOADS["gups"](n_pages=4096, block=2048, n_blocks=120,
                                         seed=3)
        res[method] = t_sim.run_sim(method, stream, n_pages=4096, fast_ratio=1 / 3,
                                    quota_pages=128, sketch_width=1 << 12,
                                    device="cpu")
    for m in ["first-touch", "pte-scan", "pebs", "tpp"]:
        assert res["neomem"].runtime < res[m].runtime * 1.02, (
            m, res[m].runtime, res["neomem"].runtime)
    assert res["neomem"].hit_rate > res["first-touch"].hit_rate


def test_convergence_after_hotset_shift():
    """Paper Fig. 16 (scaled): hit rate recovers after the hot set moves."""
    stream = t_sim.WORKLOADS["gups"](n_pages=4096, block=2048, n_blocks=160,
                                     seed=4, shift_at=80)
    r = t_sim.run_sim("neomem", stream, n_pages=4096, fast_ratio=1 / 3,
                      quota_pages=128, sketch_width=1 << 12, collect_trace=True,
                      threshold_update_period=4, device="cpu")
    hits = [t["hit_rate"] for t in r.trace]
    pre = hits[len(hits) // 2 - 1]           # just before shift
    post = hits[-1]                           # end of run
    assert post > 0.5 * pre, (pre, post)


def test_profiling_overhead_negligible():
    """Paper §VI-D: NeoProf profiling adds ~0 modeled CPU overhead."""
    stream = t_sim.WORKLOADS["gups"](n_pages=2048, block=1024, n_blocks=40, seed=5)
    r = t_sim.run_sim("neomem", stream, n_pages=2048, quota_pages=64,
                      sketch_width=1 << 12, migration_interval=4, device="cpu")
    assert r.overhead_time < 0.01 * r.runtime


# -- against the reference's runs (subprocesses started at module start) ---------

@pytest.mark.parametrize("name", list(PARITY))
def test_run_sim_matches_reference(name, reference):
    wl, method = PARITY[name]
    case = {"workload": wl, "method": method, "stream": PARITY_STREAM,
            "kw": dict(_parity_kw(method), device="cpu")}
    port = _reference_case(case, t_sim, CHIP.sim_outcome)
    _assert_outcome(port, reference[name], name)
    if method.startswith("neomem"):
        assert len(port["theta"]) == PARITY_STREAM["n_blocks"] // 4
        assert port["promoted"] > 0
        if method == "neomem-fixed":
            assert set(port["theta"]) == {FIXED_THETA}


def test_chip_smoke_sim_grid_matches_reference(reference):
    """PHASE sim's grid at 16 blocks: the CPU run chip_smoke.py holds the
    card's run to equals the reference's, cell by cell."""
    port = CHIP.cpu_sim_grid(n_blocks=GRID_BLOCKS)
    for wl in CHIP.SIM_WORKLOADS:
        for m in CHIP.SIM_METHODS:
            _assert_outcome(port[wl][m], reference[f"grid/{wl}/{m}"], f"{wl}/{m}")
            assert CHIP.sim_mismatch(port[wl][m], reference[f"grid/{wl}/{m}"]) is None
