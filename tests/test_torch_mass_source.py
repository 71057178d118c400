"""``ServeConfig.kv_mass_source`` in the port against the reference, on the
CPU, at the llama3.2-3b smoke widths.

* ``"fill"`` against the reference engine with ``kv_mass_source="fill"``
  on ``tests/test_torch_sched.py``'s scenarios: single-request decode with
  chunked prefill, lane scheduling with preemption (streamed prefill), and
  two mmpp traces with chunked prefill (on which the fill arm's kv hits
  differ from the kernel arm's), and ``chip_smoke.py``'s PHASE fill at
  smoke width (one request, and the lane trace without embeddings).  The reference runs in subprocesses with
  XLA's excess precision off and the ROADMAP C0 probe pin, the port under
  ``reference_rounding`` (ROADMAP C2); every token and step, the report's
  integers, both resources' integer TierStats (migration and flush bytes,
  hits), both placement tables and both θ traces are exactly equal.
* What the "kv" stream is fed: under ``"fill"`` each ring page's fill
  (``page_len``) with no page mass exported, under ``"kernel"`` the
  attention kernel's page mass (summing to one per step), in
  single-request and lane mode.
* An unknown source raises the reference's ``ValueError``, word for word.
"""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from test_torch_sched import (ARCH, CHIP, ROOT, SCENARIOS, _REFERENCE_MAIN,  # noqa: E402,F401
                              _assert_same, _port_run, drive, jax_params,
                              port_params, reference_rounding)

FILL = {name: dict(SCENARIOS[name], serve=dict(SCENARIOS[name]["serve"],
                                               kv_mass_source="fill"))
        for name in ("single-embeddings", "preempt", "zipf-hot-chunk8",
                     "scan-antagonist-chunk8")}
# chip_smoke.py's PHASE fill at smoke width: the two arms whose integers the
# card's run is held to
FILL["chip-fill-single"] = {
    "kind": "single", "seed": 0, "len": CHIP.FILL_PROMPT[1],
    "new": CHIP.FILL_PROMPT[2], "serve": dict(CHIP.FILL_SINGLE, resources=[])}
FILL["chip-fill-lanes"] = {
    "kind": "trace", "serve": CHIP.FILL_LANES, "sched": CHIP.LANE_SCHED,
    "profiles": [list(p) for p in CHIP.LANE_TENANTS], "trace": CHIP.FILL_TRACE}


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
    """Start the fill scenarios through the reference as the module's first
    test starts, in subprocesses side by side; :func:`reference` waits."""
    tmp = tmp_path_factory.mktemp("fill_ref")
    script = inspect.getsource(drive) + _REFERENCE_MAIN
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    names = list(FILL)
    runs = []
    for i, group in enumerate(names[i::3] for i in range(3)):
        spec, out = tmp / f"spec{i}.json", tmp / f"out{i}.json"
        spec.write_text(json.dumps({n: FILL[n] for n in group}))
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


def test_unknown_source_raises_the_references_error(jax_params, port_params):
    with pytest.raises(ValueError) as ref:
        j_engine.ServeEngine(j_smoke(ARCH), jax_params, j_engine.ServeConfig(
            paged=True, kv_mass_source="softmax"))
    with pytest.raises(ValueError) as port:
        t_engine.ServeEngine(t_registry.get_smoke_config(ARCH), port_params,
                             t_engine.ServeConfig(paged=True,
                                                  kv_mass_source="softmax"),
                             device="cpu")
    assert str(port.value) == str(ref.value)


def _kv_feed(eng):
    """Record every block the engine feeds the "kv" resource: (mass, ids)."""
    fed = []
    observe = eng.daemon.observe

    def recording(name, *args, **kw):
        if name == "kv":
            fed.append(tuple(torch.as_tensor(a).clone() for a in args))
        return observe(name, *args, **kw)
    eng.daemon.observe = recording
    return fed


def _ring_fill(eng):
    return eng._ring_view()[0]


@pytest.mark.parametrize("source", ["fill", "kernel"])
def test_single_request_kv_feed(port_params, source):
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), port_params, t_engine.ServeConfig(
            paged=True, page_t=4, hot_slots=6, migration_interval=4,
            max_seq=64, kv_mass_source=source), device="cpu")
    fed = _kv_feed(eng)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 30)).astype(np.int32)
    tok = eng.prefill(prompt)
    for _ in range(6):
        n = len(fed)
        tok = eng.step(tok)
        assert len(fed) == n + 1
        mass, ids = fed[-1]
        if source == "fill":
            assert eng._last_kv_mass is None     # no mass export under fill
            assert torch.equal(mass, torch.as_tensor(_ring_fill(eng)[0],
                                                     dtype=torch.float32))
        else:
            assert abs(float(mass.sum()) - 1.0) < 1e-4
            assert torch.equal(mass, eng._last_kv_mass.mean(dim=0))
        assert ids.shape == mass.shape


@pytest.mark.parametrize("source", ["fill", "kernel"])
def test_lane_kv_feed(port_params, source):
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), port_params, t_engine.ServeConfig(
            max_seq=48, paged=True, page_t=4, hot_slots=5, migration_interval=4,
            lanes=2, kv_segments=2, kv_mass_source=source), device="cpu")
    fed = _kv_feed(eng)
    rng = np.random.default_rng(1)
    eng.prefill_lane(0, rng.integers(0, 256, 9), segment=0, chunk=4)
    chunk_mass, _ = fed[-1]
    plen = _ring_fill(eng)
    if source == "fill":
        want = torch.as_tensor(np.where(np.arange(2)[:, None] == 0, plen, 0),
                               dtype=torch.float32)
        assert torch.equal(chunk_mass.reshape(2, -1), want)
    active, segments = np.array([True, False]), np.array([0, -1])
    for _ in range(5):
        eng.advance_lanes(rng.integers(0, 256, 2), active, segments)
        mass, ids = fed[-1]
        mass, ids = mass.reshape(2, -1), ids.reshape(2, -1)
        assert bool((mass[1] == 0).all()) and bool((ids[1] < 0).all())
        if source == "fill":
            assert eng._last_kv_mass is None
            assert torch.equal(mass[0], torch.as_tensor(
                np.where(ids[0].numpy() >= 0, _ring_fill(eng)[0], 0),
                dtype=torch.float32))
        else:
            assert abs(float(mass[0].sum()) - 1.0) < 1e-4


@pytest.mark.parametrize("name", list(FILL))
def test_fill_source_matches_reference(name, reference, port_params,
                                       reference_rounding):
    """Under "fill": requests, report, both resources' TierStats integers,
    placement tables and θ traces all equal the reference's."""
    ref = reference[name]
    port = _port_run(FILL[name], port_params, reference["seeds"])
    _assert_same(port, ref)
    assert port["stats"]["kv"]["migration_bytes"] > 0
    assert port["stats"]["kv"]["flush_bytes"] > 0
