"""The four example twins (``examples/*_torch.py``) against the reference's
examples, on the CPU.

At the first test each reference example runs in a subprocess of its own
(``runpy.run_path(..., run_name="__main__")``, the C0 probe pin, XLA's
excess precision off), which pickles what it printed and the integers it
left: the resource's placement tables, θ trace and counters; for
``serve_longctx`` its weights and, run as shipped and again from the weights
cast to float32, its tokens, decode logits and ``tier_stats()``; for
``train_tiered_moe`` (``--steps 2 --batch 2 --seq 32``) its initial weights,
each step's loss, the router streams it fed the experts resource and a
digest of each final leaf.  The twins run in this process on one intra-op
thread meanwhile.

* quickstart and profile_embeddings at their own sizes: every printed line
  and every integer equal;
* serve_longctx from the reference's weights (``params_from_jax``) cast to
  float32 on both sides: tokens and every integer of ``tier_stats()``
  equal; as shipped (bf16), with swiglu's activation rounded op by op as the
  flag-off reference rounds it (ROADMAP C2), the tokens part only at the
  named near-tie ``SERVE_NEAR_TIE``;
* train_tiered_moe from the reference's weights: each step's loss within
  ``LOSS_TOL`` (observed 0.011 and 0.004: the bf16 step's own rounding);
  the twin's experts resource fed the
  reference's streams gives its integers; the twin resumes from the
  checkpoint that the reference wrote, its params bitwise the reference's
  final ones.
"""
import contextlib
import hashlib
import importlib.util
import io
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "profile_embeddings", "serve_longctx", "train_tiered_moe")
TRAIN_ARGS = dict(steps=2, batch=2, seq=32)
LOSS_TOL = 2e-2          # |loss - reference loss| at each step (losses ~10.8)
SERVE_NEAR_TIE = (5, 0)  # (decode step, row) where serve_longctx's bf16 picks part
SERVE_LOGIT_TOL = 0.07   # bf16 logits before it (a few ulps of |logit| < 8)
COUNTERS = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong")
INT_STATS = COUNTERS + ("migration_bytes", "last_epoch_bytes", "max_epoch_bytes",
                        "quota_bytes", "migration_epochs", "flush_bytes",
                        "inflight_bytes")

_REFERENCE = """
import contextlib, functools, hashlib, io, os, pickle, runpy, sys
import numpy as np
import jax
import repro.dist.host_offload as ho
ho._probe_cache["kinds"] = ("device",)   # ROADMAP C0
from repro import tiering as tm
from repro.models import transformer as tr

name, out, root = sys.argv[1:4]
script = os.path.join(root, "examples", name + ".py")
dump = {}


def integers(h):
    row = h.snapshot()
    return dict(page_slot=np.asarray(h.state.tier.page_slot),
                slot_page=np.asarray(h.state.tier.slot_page),
                theta_trace=[int(t) for t in h.stats.theta_trace],
                counters={k: int(row[k]) for k in %(counters)r})


init = tr.init_params


def init_params(cfg, key):
    params = init(cfg, key)
    dump["params"] = jax.tree.map(np.asarray, params)
    return params


tr.init_params = init_params
if name == "serve_longctx":
    from repro.serve.engine import ServeEngine
    generate, advance = ServeEngine.generate, ServeEngine._advance

    def recorded(self, prompt, n_tokens, **kw):
        run = dump.setdefault(dump.get("dtype", "bf16"), {"logits": []})
        toks = generate(self, prompt, n_tokens, **kw)
        run["tokens"] = np.asarray(toks)
        run["tier_stats"] = self.tier_stats()
        run["handles"] = {n: integers(h) for n, h in self.daemon.resources.items()}
        return toks

    def advancing(self, tok):
        logits = advance(self, tok)
        dump[dump.get("dtype", "bf16")]["logits"].append(
            np.asarray(logits[:, -1], np.float32))
        return logits
    ServeEngine.generate, ServeEngine._advance = recorded, advancing
if name == "train_tiered_moe":
    sys.argv = [script, "--steps", "%(steps)d", "--batch", "%(batch)d", "--seq",
                "%(seq)d", "--ckpt", os.path.join(out, "ckpt")]
    dump["losses"], dump["streams"] = [], []
    jit, observe = jax.jit, tm.ResourceHandle.observe

    def recording_jit(fn, *a, **kw):
        f = jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "step":
            return f

        @functools.wraps(fn)
        def step(*args):
            res = f(*args)
            dump["losses"].append(float(res[2]))
            dump["final"] = [hashlib.sha1(np.ascontiguousarray(np.asarray(x)).view(
                np.uint8)).hexdigest() for x in jax.tree.leaves(res[0])]
            return res
        return step

    def observing(self, *observation, **kw):
        dump["streams"].append(np.asarray(observation[0]))
        dump["handle"] = self
        return observe(self, *observation, **kw)
    jax.jit, tm.ResourceHandle.observe = recording_jit, observing
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    g = runpy.run_path(script, run_name="__main__")
dump["lines"] = buf.getvalue().splitlines()
if name == "serve_longctx":      # the same run from the weights cast to float32
    import jax.numpy as jnp
    dump["dtype"] = "f32"
    tr.init_params = lambda cfg, key: jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, init(cfg, key))
    with contextlib.redirect_stdout(io.StringIO()):
        g["main"]()
h = {"quickstart": g.get("h"), "profile_embeddings": g.get("rows"),
     "train_tiered_moe": dump.pop("handle", None)}.get(name)
if h is not None:
    dump.update(integers(h))
with open(os.path.join(out, "ref.pkl"), "wb") as f:
    pickle.dump(dump, f, protocol=5)
""" % dict(counters=COUNTERS, **TRAIN_ARGS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Start every reference example at once; ``reference(name)`` waits for
    one and returns what it dumped (and its output directory)."""
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for name in EXAMPLES:
        out = tmp_path_factory.mktemp(name)
        runs[name] = (subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, name, str(out), str(ROOT)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True), out)
    done = {}

    def wait(name):
        if name not in done:
            proc, out = runs[name]
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            with open(out / "ref.pkl", "rb") as f:
                done[name] = pickle.load(f), out
        return done[name]
    yield wait
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def twin(name: str):
    """The twin ``examples/<name>_torch.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(fn, **kw) -> tuple:
    """``fn(**kw)`` and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(**kw)
    return res, buf.getvalue().splitlines()


def hold_integers(got: dict, want: dict, what: str) -> None:
    np.testing.assert_array_equal(got["page_slot"], want["page_slot"], err_msg=what)
    np.testing.assert_array_equal(got["slot_page"], want["slot_page"], err_msg=what)
    assert got["theta_trace"] == want["theta_trace"], what
    assert got["counters"] == want["counters"], what


@pytest.mark.parametrize("name", ["quickstart", "profile_embeddings"])
def test_tiering_twin_prints_and_places_as_reference(name, reference):
    res, lines = run_main(twin(name).main, device="cpu")
    ref, _ = reference(name)
    assert lines == ref["lines"]
    hold_integers(res, ref, name)
    if name == "quickstart":
        assert lines[-1] == f"hot pages resident: {res['resident']} / 600"
        assert res["resident"] == int((ref["page_slot"][7000:7600] >= 0).sum())


def _float32(tree):
    return tree_unflatten(tree, [x.float() if x.dtype == torch.bfloat16 else x
                                 for x in tree_leaves(tree)])


def test_serve_longctx_twin_matches_reference_f32(reference):
    """From the reference's weights cast to float32 on both sides (the
    KV pages stay bf16): tokens and every integer of ``tier_stats()`` and of
    each resource equal."""
    ref, _ = reference("serve_longctx")
    res, lines = run_main(twin("serve_longctx").main, device="cpu",
                          params=_float32(params_from_jax(ref["params"], device="cpu")))
    want = ref["f32"]
    np.testing.assert_array_equal(res["tokens"], want["tokens"])
    assert sorted(res["tier_stats"]) == sorted(want["tier_stats"]) == ["embeddings", "kv"]
    for name, row in res["tier_stats"].items():
        assert {k: row[k] for k in INT_STATS} == {
            k: int(want["tier_stats"][name][k]) for k in INT_STATS}, name
        assert row["hit_rate"] == want["tier_stats"][name]["hit_rate"], name
        h = res["engine"].daemon[name]
        hold_integers(dict(page_slot=h.state.tier.page_slot.numpy(),
                           slot_page=h.state.tier.slot_page.numpy(),
                           theta_trace=list(h.stats.theta_trace),
                           counters={k: row[k] for k in COUNTERS}),
                      want["handles"][name], name)


def test_serve_longctx_twin_bf16_parts_only_at_named_near_tie(reference, monkeypatch):
    """The example as shipped (bf16 weights), swiglu's silu rounded op by op
    as the flag-off reference rounds it (ROADMAP C2): every printed line but
    the timing and the sample are the reference's, and the greedy tokens
    are equal up to ``SERVE_NEAR_TIE`` (decode step, row), where the
    reference's top two logits lie one bf16 ulp apart and the logits of the
    two packages, a one-pass and a page-by-page sum of the same pages
    (ROADMAP Queue C), differ by up to two; every step before it stays
    within ``SERVE_LOGIT_TOL``."""
    ref, _ = reference("serve_longctx")
    monkeypatch.setattr(t_layers.F, "silu", lambda x: x * (1 / (1 + torch.exp(-x))))
    logits = []

    def on_engine(eng):
        advance = eng._advance

        def recorded(tok):
            out = advance(tok)
            logits.append(out[:, -1].float().numpy())
            return out
        eng._advance = recorded
    res, lines = run_main(twin("serve_longctx").main, device="cpu",
                          params=params_from_jax(ref["params"], device="cpu"),
                          on_engine=on_engine)
    want = ref["bf16"]
    skip = ("tok/s", "sample:")
    assert [x for x in lines if not x.startswith(skip) and "tok/s" not in x] == [
        x for x in ref["lines"] if not x.startswith(skip) and "tok/s" not in x]
    parted = np.flatnonzero((res["tokens"] != want["tokens"]).any(0))
    assert parted.size and parted[0] == SERVE_NEAR_TIE[0]
    step, row = SERVE_NEAR_TIE
    np.testing.assert_array_equal(res["tokens"][:, :step], want["tokens"][:, :step])
    assert np.flatnonzero(res["tokens"][:, step] != want["tokens"][:, step]).tolist() == [row]
    for i in range(step):                 # decode steps 1..step: logits[i - 1]
        np.testing.assert_allclose(logits[i], want["logits"][i], rtol=0,
                                   atol=SERVE_LOGIT_TOL, err_msg=f"step {i + 1}")
    top = np.sort(want["logits"][step - 1][row])[-2:]
    assert top[1] - top[0] <= 2.0 ** (np.floor(np.log2(top[1])) - 7)


@pytest.fixture(scope="module")
def train_twin(reference, tmp_path_factory):
    """The training twin from the reference's initial weights at
    ``TRAIN_ARGS``, in a fresh checkpoint directory."""
    ref, out = reference("train_tiered_moe")
    mod = twin("train_tiered_moe")
    params = params_from_jax(ref.pop("params"), device="cpu")
    ckpt = tmp_path_factory.mktemp("twin_ckpt")
    res, lines = run_main(mod.main, device="cpu", ckpt=str(ckpt), params=params,
                          **TRAIN_ARGS)
    return mod, ref, out, params, res, lines


def test_train_twin_losses_match_reference(train_twin):
    _, ref, _, _, res, lines = train_twin
    assert res["start"] == 0 and len(res["losses"]) == TRAIN_ARGS["steps"]
    assert all(np.isfinite(res["losses"]))
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=0, atol=LOSS_TOL)
    assert lines[0] == ref["lines"][0]          # the parameter count
    assert [r["step"] for r in res["records"]] == [0, TRAIN_ARGS["steps"] - 1]


def test_train_twin_experts_replay_reference_streams(train_twin):
    """The twin's experts resource fed the reference's router streams, a
    tick after each step, gives the reference's integers."""
    mod, ref, *_ = train_twin
    assert len(ref["streams"]) == TRAIN_ARGS["steps"]
    daemon, experts = mod.tiered_experts("cpu")
    for streams in ref["streams"]:
        experts.observe(torch.from_numpy(np.array(streams)))
        daemon.tick()
    row = experts.snapshot()
    hold_integers(dict(page_slot=experts.state.tier.page_slot.numpy(),
                       slot_page=experts.state.tier.slot_page.numpy(),
                       theta_trace=list(experts.stats.theta_trace),
                       counters={k: row[k] for k in COUNTERS}), ref, "experts")


def test_train_twin_resumes_reference_checkpoint_bitwise(train_twin, tmp_path):
    mod, ref, out, params, _, _ = train_twin
    ckpt = tmp_path / "ckpt"
    shutil.copytree(out / "ckpt", ckpt)
    res, lines = run_main(mod.main, device="cpu", ckpt=str(ckpt), params=params,
                          **TRAIN_ARGS)
    assert res["start"] == TRAIN_ARGS["steps"] and res["losses"] == []
    assert f"resuming from checkpoint step {TRAIN_ARGS['steps']}" in lines

    def digest(x):
        a = x.detach().contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return hashlib.sha1(a.numpy().view(np.uint8)).hexdigest()
    assert [digest(x) for x in tree_leaves(res["params"])] == ref["final"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_refuses_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(name).main(device="cuda")
