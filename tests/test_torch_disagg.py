"""The port's disaggregated prefill/decode against the reference, on the CPU.

Ports of ``tests/test_disagg.py`` at the llama3.2-3b smoke widths: split
pools equal the unified scheduler token for token (greedy and at
temperature 0.8), preemption in mid-prefill resumes bitwise, the
hand-off residency gate holds, disaggregation needs chunked prefill, the
TierStats conservation laws hold in both modes, reuse works across the
split with its references drained, and the report carries the mode, the
per-role clocks and the hand-off schema.

Against the reference (run in a subprocess with XLA's excess precision off
and the ROADMAP C0 probe pin, the port under ``reference_rounding``,
ROADMAP C2): the work set through the split pools, greedy, and
``chip_smoke.py``'s PHASE disagg trace at smoke width, sampled at
temperature 0.8 and top-p 0.9 — every token, step, hand-off count and
byte, integer TierStats, placement table and θ trace equal; and the
schedule ``chip_smoke.py`` holds the card's run to equals the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import sched as t_sched  # noqa: E402
from repro_torch.tiering.migrate import segment_page_ids  # noqa: E402
from test_torch_reuse import (CHIP, port_params, port_run,  # noqa: E402,F401
                              reference_rounding, start_reference,
                              stop_reference, wait_reference)

ARCH = "llama3.2-3b"
BASE_KW = dict(max_seq=48, paged=True, page_t=4, hot_slots=5,
               migration_interval=4, resources=("embeddings",),
               embed_hot_slots=4, embed_rows_per_page=8)
CHUNK = 4
_WORK = [("a", 1, 18, 5), ("b", 2, 6, 6), ("a", 3, 11, 4),
         ("b", 4, 21, 3), ("a", 5, 9, 5)]

SCENARIOS = {
    "disagg-work": {
        "kind": "ops", "serve": dict(BASE_KW, resources=["embeddings"], lanes=2,
                                     kv_segments=5),
        "tenants": [["a", 1.0], ["b", 1.0]],
        "ops": [["submit", t, s, n, m] for t, s, n, m in _WORK] + [["run"]],
        "sched": dict(preempt_patience=16, prefill_chunk=CHUNK, prefill_lanes=1,
                      seed=7)},
    # PHASE disagg's trace at 100 arrival steps, and cut as the phase runs it
    "chip-disagg": {"kind": "trace", "serve": CHIP.DISAGG_SERVE,
                    "sched": CHIP.DISAGG_SCHED, "profiles": None,
                    "trace": dict(CHIP.DISAGG_TRACE, n_steps=100)},
    "chip-disagg-cut": {"kind": "trace", "serve": CHIP.DISAGG_SERVE,
                        "sched": CHIP.DISAGG_SCHED, "profiles": None,
                        "trace": CHIP.DISAGG_TRACE},
}
CHIP_DISAGG = ("chip-disagg", "chip-disagg-cut")


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
    runs = start_reference(tmp_path_factory.mktemp("disagg_ref"),
                           [{n: s} for n, s in SCENARIOS.items()])
    yield runs
    stop_reference(runs)


@pytest.fixture(scope="module")
def reference(_reference_runs):
    return wait_reference(_reference_runs)


def _sched(params, prefill_lanes, lanes=2, temp=0.0, reuse=0, patience=16,
           chunk=CHUNK, segments=None):
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), params, t_engine.ServeConfig(
            **BASE_KW, lanes=lanes, kv_segments=segments or (lanes + prefill_lanes + 2),
            reuse_pages=reuse), device="cpu")
    return t_sched.Scheduler(eng, [t_sched.Tenant("a"), t_sched.Tenant("b")],
                             t_sched.SchedConfig(
                                 preempt_patience=patience, prefill_chunk=chunk,
                                 prefill_lanes=prefill_lanes, temperature=temp,
                                 seed=7))


def _prompt(seed, n=8):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _serve(sched):
    reqs = [sched.submit(t, _prompt(s, n), max_new=m) for t, s, n, m in _WORK]
    sched.run(max_steps=2000)
    return {r.rid: list(r.out) for r in reqs}, reqs


@pytest.fixture(scope="module")
def served(port_params):
    """The work set served greedy through the unified scheduler and through
    the split pools, once for the tests that read those runs: {prefill
    lanes: (scheduler, outputs)}; no test steps them again."""
    out = {}
    for pre in (0, 1):
        sched = _sched(port_params, prefill_lanes=pre)
        out[pre] = (sched, _serve(sched)[0])
    return out


@pytest.fixture(scope="module")
def generate(port_params):
    """The port's single-request engine: what every greedy request of the
    split pools must reproduce."""
    eng = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH), port_params,
        t_engine.ServeConfig(**dict(BASE_KW, resources=())), device="cpu")
    return lambda prompt, n: list(eng.generate(np.asarray(prompt)[None],
                                               n_tokens=n)[0])


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_disagg_bit_exact_vs_unified(port_params, served, temp):
    """The same requests through the unified scheduler and through the split
    pools: token for token equal, real hand-off bytes both ways."""
    if temp == 0.0:
        (uni, uni_out), (dis, dis_out) = served[0], served[1]
    else:
        uni = _sched(port_params, prefill_lanes=0, temp=temp)
        dis = _sched(port_params, prefill_lanes=1, temp=temp)
        uni_out, dis_out = _serve(uni)[0], _serve(dis)[0]
    assert uni_out == dis_out
    assert uni.handoffs == 0 and uni.handoff_bytes_out == 0
    assert dis.handoffs == len(_WORK)
    assert dis.handoff_bytes_out > 0 and dis.handoff_bytes_in > 0


def test_disagg_matches_reference(reference, port_params, generate,
                                  reference_rounding):
    """The work set through the split pools: every token, step, hand-off,
    integer TierStats, placement table and θ trace the reference's; and
    every request the single-request engine's tokens."""
    port = port_run(SCENARIOS["disagg-work"], port_params, reference["seeds"])
    ref = reference["disagg-work"]
    for key in ref:
        assert port[key] == ref[key], key
    assert port["report"]["handoff"]["count"] == len(_WORK)
    for (_, _, seed, n, m), req in zip(SCENARIOS["disagg-work"]["ops"],
                                       port["requests"]):
        assert req[3] == generate(_prompt(seed, n), m), req[0]


def test_sampled_disagg_trace_matches_reference(reference, port_params,
                                                reference_rounding):
    """PHASE disagg's trace at smoke width (at 100 arrival steps), sampled
    at temperature 0.8 and top-p 0.9 through the threefry port: everything
    equal, tokens too."""
    port = port_run(SCENARIOS["chip-disagg"], port_params, reference["seeds"])
    ref = reference["chip-disagg"]
    for key in ref:
        assert port[key] == ref[key], key


def test_chip_smoke_disagg_schedule_matches_reference(reference):
    """The schedule ``chip_smoke.py`` computes on the CPU for PHASE disagg
    (at 100 arrival steps, and at the phase's cut, which it holds the
    card's run to): steps, each request's steps, hand-offs (in pages),
    equal to the reference's."""
    cfg = t_registry.get_smoke_config(ARCH)
    kv_row = cfg.n_groups * CHIP.DISAGG_SERVE["page_t"] * cfg.n_kv_heads * 2 \
        * cfg.head_dim * 2                           # bf16 [K | V] page
    for name in CHIP_DISAGG:
        ref = reference[name]
        ho = ref["report"]["handoff"]
        assert CHIP.cpu_disagg_schedule(SCENARIOS[name]["trace"]) == {
            "steps": ref["report"]["steps"],
            "preemptions": ref["report"]["preemptions"],
            "requests": [[rid, adm, fin, pre, steps]
                         for rid, _, _, _, adm, fin, pre, steps in ref["requests"]],
            "handoff": {"count": ho["count"], "pages_out": ho["bytes_out"] // kv_row,
                        "pages_in": ho["bytes_in"] // kv_row,
                        "depth_peak": ho["depth_peak"]}}, name
        assert ho["bytes_out"] % kv_row == 0 and ho["bytes_in"] % kv_row == 0


def test_mid_prefill_preempt_resume_parity(port_params, generate):
    """Preempted between prefill chunks on the prefill worker, the request
    resumes on the pool and still decodes token for token."""
    sched = _sched(port_params, prefill_lanes=1)
    ra = sched.submit("a", _prompt(30, 20), max_new=6)     # 5 chunks of 4
    for _ in range(50):
        sched.step()
        if ra.state == "prefill" and 0 < ra.pos < ra.n_prompt:
            break
    assert ra.state == "prefill" and ra.prefilling, "never mid-prefill"
    sched._preempt(ra)
    assert ra.state == "preempted" and ra.prefilling and sched.pre_lanes[0] is None
    sched.run(max_steps=2000)
    assert ra.state == "finished" and ra.preemptions >= 1
    assert ra.out == generate(ra.prompt, 6)


def test_handoff_residency_gate(port_params, generate):
    """Decode admission waits on the write witness: a hand-off with an
    unflushed page is not admissible and installing it raises; once the
    page is witnessed the request drains normally."""
    sched = _sched(port_params, prefill_lanes=1)
    ra = sched.submit("a", _prompt(31, 14), max_new=4)
    for _ in range(50):
        if sched.handoff:
            break
        sched.step()
    assert sched.handoff, "request never reached the hand-off state"
    res, eng = ra.residual, sched.eng
    gids = segment_page_ids(res["segment"], res["pos"], eng.scfg.page_t,
                            eng.pages_per_seq, table=res.get("pages"))
    assert eng.segment_resident(res)
    mem = eng.daemon["kv"].mem
    mem.written[int(gids[-1])] = False          # an in-flight flush
    assert not eng.segment_resident(res)
    with pytest.raises(RuntimeError, match="not fully resident"):
        eng.install_handoff(0, res)
    before = sched.step_count
    sched.step()
    assert ra.state == "handoff" and sched.step_count == before + 1
    mem.written[int(gids[-1])] = True           # the flush lands
    sched.run(max_steps=2000)
    assert ra.out == generate(ra.prompt, 4)


def test_disagg_requires_chunked_prefill(port_params):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _sched(port_params, prefill_lanes=1, chunk=0)


def test_attached_engine_geometry_checked(port_params):
    """A worker engine may differ from its owner in the lane count only."""
    owner = _sched(port_params, prefill_lanes=0).eng
    bad = dataclasses.replace(owner.scfg, lanes=1, page_t=8)
    with pytest.raises(ValueError, match="page_t"):
        t_engine.ServeEngine(owner.cfg, owner.params, bad, device="cpu",
                             attach_to=owner)


def _check_conservation(resources):
    """Every metered read is fast or slow, and the per-epoch migration
    budget held for every epoch."""
    for name, row in resources.items():
        reads = row["fast_reads"] + row["slow_reads"]
        assert abs(row["hit_rate"] - (row["fast_reads"] / reads if reads else 0.0)) \
            < 1e-9, name
        assert row["last_epoch_bytes"] <= row["max_epoch_bytes"], name
        if row["quota_bytes"]:
            assert row["max_epoch_bytes"] <= row["quota_bytes"], name


@pytest.mark.parametrize("pre", [0, 1])
def test_tier_stats_conservation(served, pre):
    sched = served[pre][0]
    rep = sched.report()
    _check_conservation(rep["resources"])
    for stats in sched.tenant_stats.values():
        _check_conservation({stats.name: stats.as_row()})
    if pre:
        assert rep["resources"]["kv"]["flush_bytes"] > 0
        assert rep["handoff"]["bytes_out"] > 0


def test_disagg_reuse_bit_exact_and_refs_drain(port_params):
    """Matching on the prefill worker, publishing on the decode worker:
    outputs equal unified + reuse, and every claim drains."""
    uni = _sched(port_params, prefill_lanes=0, reuse=8)
    dis = _sched(port_params, prefill_lanes=1, reuse=8)
    assert _serve(uni)[0] == _serve(dis)[0]
    st = dis.eng.reuse.stats()
    assert st["lookups"] > 0 and st["shared_refs"] == 0
    assert dis.peng.reuse is dis.eng.reuse and dis.peng.daemon is dis.eng.daemon


def test_report_mode_clock_and_handoff_schema(served):
    uni, dis = served[0][0], served[1][0]
    ru, rd = uni.report(), dis.report()
    assert ru["mode"] == "unified" and ru["prefill_lanes"] == 0
    assert rd["mode"] == "disagg" and rd["prefill_lanes"] == 1
    for rep in (ru, rd):
        assert set(rep["clock"]) == {"prefill_s", "handoff_s", "decode_s"}
        assert set(rep["handoff"]) == {"count", "bytes_out", "bytes_in",
                                       "depth_peak"}
    assert ru["handoff"]["count"] == 0 and ru["clock"]["prefill_s"] == 0.0
    assert rd["handoff"]["count"] == len(_WORK) and rd["handoff"]["depth_peak"] >= 1
    assert rd["clock"]["prefill_s"] > 0 and rd["clock"]["decode_s"] > 0
    for r in dis.finished:
        assert len(r.token_clock) == len(r.token_steps) == len(r.out)
    assert len(dis.prefill_busy) == dis.step_count
