"""The port's paged decode and serve engine against the reference, on the CPU,
at the llama3.2-3b smoke widths, starting from the reference's exact
weights (``params_from_jax``) and H3 seeds.

float32 (params and cache): logits within 1e-4 and per-page mass within
1e-5 over 16 teacher-forced steps — only summation order differs.

bf16 rounds in three ways here (ROADMAP C2):
  * the reference as jitted by default: XLA keeps bf16 intermediates in
    float32 inside a fusion (``--xla_allow_excess_precision`` is on);
  * the reference with that flag off: every op rounds to bf16, swiglu's
    ``jax.nn.silu`` as ``x * (1 / (1 + exp(-x)))``, op by op;
  * the port: eager PyTorch, every op rounds to bf16 except ``F.silu``,
    which computes in float32 and rounds once.
``reference_rounding`` swaps the port's ``F.silu`` for the op-by-op formula
inside a test; against the flag-off reference (run in a subprocess) the
port's greedy tokens, engine tokens and integer TierStats are then equal.
The port as shipped agrees with the default reference to a few bf16 ulps
of the logits and parts from its greedy tokens only at the one near-tie
``test_decode_step_paged_bf16_shipped_parts_only_at_named_near_tie`` names.
"""
import functools
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

from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

ARCH = "llama3.2-3b"
PAGE_T, SLOTS, B = 4, 4, 2


@pytest.fixture(scope="module")
def jax_params():
    return j_tr.init_params(j_smoke(ARCH), jax.random.PRNGKey(0))


SCFG = dict(paged=True, page_t=4, hot_slots=6, migration_interval=4,
            kv_quota=16, max_seq=64)
INT_STATS = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
             "migration_bytes", "last_epoch_bytes", "max_epoch_bytes",
             "quota_bytes", "migration_epochs", "flush_bytes", "inflight_bytes")
PROMPT_LENS = (20, 30)
GREEDY_START = [[5], [77]]

_BF16_REFERENCE = """
import functools, json, sys
import numpy as np, jax, jax.numpy as jnp
import repro.dist.host_offload as ho
ho._probe_cache["kinds"] = ("device",)   # ROADMAP C0
from repro.configs.registry import get_smoke_config
from repro.models import decode as dec, transformer as tr
from repro.serve.engine import ServeConfig, ServeEngine
arch, out, scfg, lens, start = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), \
    json.loads(sys.argv[4]), json.loads(sys.argv[5])
cfg = get_smoke_config(arch)
params = tr.init_params(cfg, jax.random.PRNGKey(0))
step = jax.jit(functools.partial(dec.decode_step_paged, cfg, page_t=%(page_t)d))
cache = dec.init_paged_cache(cfg, %(b)d, %(slots)d, %(page_t)d)
tok, greedy, logits = jnp.asarray(start), [], []
for _ in range(16):
    lg, cache = step(params, cache, tok)
    tok = jnp.argmax(lg[:, -1], -1)[:, None]
    greedy.append(np.asarray(tok[:, 0]))
    logits.append(np.asarray(lg[:, -1]))
res = {"greedy": np.stack(greedy), "logits": np.stack(logits)}
stats = {}
for n in lens:
    prompt = np.random.default_rng(n).integers(0, cfg.vocab, (%(b)d, n)).astype(np.int32)
    eng = ServeEngine(cfg, params, ServeConfig(**scfg))
    res[f"tokens{n}"] = eng.generate(prompt, 16)
    h = eng.daemon["kv"]
    res[f"seeds{n}"] = np.asarray(h.state.prof.sketch.seeds)
    res[f"page_slot{n}"] = np.asarray(h.state.tier.page_slot)
    stats[n] = {"row": eng.tier_stats()["kv"], "steps": eng.step_count,
                "theta": h.stats.theta_trace}
np.savez(out + ".npz", **res)
json.dump(stats, open(out + ".json", "w"))
""" % dict(page_t=PAGE_T, b=B, slots=SLOTS)


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    """The reference's bf16 greedy decode and engine runs, computed in a
    subprocess with XLA's excess precision off (see the module docstring)."""
    root = Path(__file__).resolve().parents[1]
    out = str(tmp_path_factory.mktemp("bf16_ref") / "ref")
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _BF16_REFERENCE, ARCH, out, json.dumps(SCFG),
         json.dumps(PROMPT_LENS), json.dumps(GREEDY_START)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out + ".npz")), json.load(open(out + ".json"))


def _silu_op_by_op(x):
    """``jax.nn.silu``'s formula, rounding after every op in x's dtype."""
    return x * (1 / (1 + torch.exp(-x)))


@pytest.fixture
def reference_rounding(monkeypatch):
    """Round swiglu's activation where the flag-off reference rounds."""
    monkeypatch.setattr(t_layers.F, "silu", _silu_op_by_op)


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _runners(jparams, dtype):
    cfg = j_smoke(ARCH)
    tcfg = t_registry.get_smoke_config(ARCH)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    if dtype == "f32":
        jparams = _f32(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg,
                                      page_t=PAGE_T, return_streams=True))
    jcache = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T, dtype=jdt)
    tcache = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, dtype=tdt,
                                    device="cpu")
    return cfg, tcfg, jparams, tparams, jstep, jcache, tcache


def test_decode_step_paged_f32_matches_reference(jax_params):
    """16 steps wrap the 4-slot ring of 4-token pages twice over."""
    cfg, tcfg, jp, tp, jstep, jc, tc = _runners(jax_params, "f32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (16, B, 1))
    for step in range(16):
        jl, jc, js = jstep(jp, jc, jnp.asarray(toks[step]))
        tl, tc, ts = t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(toks[step]),
                                             page_t=PAGE_T, return_streams=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"logits step {step}")
        np.testing.assert_allclose(ts["kv_mass"].numpy(), np.asarray(js["kv_mass"]),
                                   atol=1e-5, rtol=0, err_msg=f"mass step {step}")
    ring = jc["blocks"][0]
    for key in ("page_len", "cur_slot"):
        np.testing.assert_array_equal(tc["blocks"][0][key].numpy(),
                                      np.asarray(ring[key]))
    np.testing.assert_allclose(tc["blocks"][0]["k_pages"].numpy(),
                               np.asarray(ring["k_pages"]), atol=1e-5, rtol=0)
    assert int(tc["pos"]) == int(jc["pos"]) == 16


def test_decode_step_paged_bf16_greedy_matches_reference(jax_params,
                                                        bf16_reference,
                                                        reference_rounding):
    ref, _ = bf16_reference
    tcfg = t_registry.get_smoke_config(ARCH)
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    tc = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, device="cpu")
    tok, greedy, logits = torch.tensor(GREEDY_START), [], []
    for _ in range(16):
        lg, tc = t_dec.decode_step_paged(tcfg, tp, tc, tok, page_t=PAGE_T)
        tok = lg[:, -1].argmax(-1)[:, None]
        greedy.append(tok[:, 0].numpy())
        logits.append(lg[:, -1].numpy())
    np.testing.assert_array_equal(np.stack(greedy), ref["greedy"])
    np.testing.assert_allclose(np.stack(logits), ref["logits"], atol=1e-2, rtol=0)


NEAR_TIES = {(14, 0)}     # (step, batch row) where the greedy picks part


def test_decode_step_paged_bf16_shipped_parts_only_at_named_near_tie(jax_params):
    """The port as shipped (``F.silu``) against the reference as jitted by
    default, teacher-forced on the reference's greedy tokens for 16 steps.
    Logits stay within 0.07 (a few bf16 ulps; the largest gap seen is
    0.0625).  The greedy picks are equal at every step but step 14, row 0:
    there the reference's top two logits are 1/64 apart, the port's are an
    exact bf16 tie, and argmax takes the tie's lower token id."""
    cfg = j_smoke(ARCH)
    tcfg = t_registry.get_smoke_config(ARCH)
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    jstep = jax.jit(functools.partial(j_dec.decode_step_paged, cfg, page_t=PAGE_T))
    jc = j_dec.init_paged_cache(cfg, B, SLOTS, PAGE_T)
    tc = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, device="cpu")
    tok, parted = np.asarray(GREEDY_START), set()
    for step in range(16):
        jl, jc = jstep(jax_params, jc, jnp.asarray(tok))
        tl, tc = t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(tok),
                                         page_t=PAGE_T)
        jl, tl = np.asarray(jl[:, -1]), tl[:, -1].numpy()
        np.testing.assert_allclose(tl, jl, atol=0.07, rtol=0,
                                   err_msg=f"logits step {step}")
        for row in np.flatnonzero(tl.argmax(-1) != jl.argmax(-1)):
            parted.add((step, int(row)))
            top_ref, top_port = np.sort(jl[row])[-2:], np.sort(tl[row])[-2:]
            assert top_ref[1] - top_ref[0] == 1 / 64
            assert top_port[1] == top_port[0]
            assert tl[row, jl[row].argmax()] == top_port[1]
        tok = jl.argmax(-1)[:, None]
    assert parted == NEAR_TIES


def test_prefill_paged_equals_streaming(jax_params):
    """A prefill chunk leaves the ring exactly as token-at-a-time steps."""
    tcfg = t_registry.get_smoke_config(ARCH)
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, 11)))
    c1 = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, device="cpu")
    c2 = t_dec.init_paged_cache(tcfg, B, SLOTS, PAGE_T, device="cpu")
    last, c1, streams = t_dec.prefill_paged(tcfg, tp, c1, toks, page_t=PAGE_T,
                                            collect_mass=True)
    for c in range(11):
        logits, c2 = t_dec.decode_step_paged(tcfg, tp, c2, toks[:, c:c + 1],
                                             page_t=PAGE_T)
    assert torch.equal(last, logits[:, -1])
    for key in ("k_pages", "v_pages", "page_len", "cur_slot"):
        assert torch.equal(c1["blocks"][0][key], c2["blocks"][0][key]), key
    assert streams["kv_mass"].shape == (11, tcfg.n_groups, 1, B, SLOTS)


@pytest.mark.parametrize("prompt_len", PROMPT_LENS)
def test_engine_generate_matches_reference(jax_params, bf16_reference,
                                           reference_rounding, prompt_len):
    """Tokens, the kv tier_stats integers, the placement table and the θ
    trace; a 30-token prompt spans two ring-capacity prefill chunks, so the
    ring wraps during prefill."""
    ref, stats = bf16_reference
    want = stats[str(prompt_len)]
    prompt = np.random.default_rng(prompt_len).integers(
        0, 256, (B, prompt_len)).astype(np.int32)
    te = t_engine.ServeEngine(
        t_registry.get_smoke_config(ARCH),
        params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu"),
        t_engine.ServeConfig(**SCFG), device="cpu",
        sketch_seeds=sketch_seeds_from_jax(ref[f"seeds{prompt_len}"]))
    np.testing.assert_array_equal(te.generate(prompt, 16),
                                  ref[f"tokens{prompt_len}"])
    row = te.tier_stats()["kv"]
    assert {k: row[k] for k in INT_STATS} == {k: want["row"][k] for k in INT_STATS}
    assert row["migration_bytes"] > 0 and row["flush_bytes"] > 0
    assert te.step_count == want["steps"]
    ht = te.daemon["kv"]
    np.testing.assert_array_equal(ht.state.tier.page_slot.numpy(),
                                  ref[f"page_slot{prompt_len}"])
    assert ht.stats.theta_trace == want["theta"]


def test_init_params_matches_reference_layout():
    """Same tree, shapes and dtypes as the reference's init (smoke width)."""
    cfg = j_smoke(ARCH)
    ref = jax.eval_shape(lambda: j_tr.init_params(cfg, jax.random.PRNGKey(0)))
    port = t_tr.init_params(t_registry.get_smoke_config(ARCH), seed=0,
                            device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    conv = params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), ref), device="cpu")
    port_flat = dict(_flatten(port))
    assert set(port_flat) == set(dict(_flatten(conv)))
    for path, leaf in ref_leaves:
        key = jax.tree_util.keystr(path)
        t = port_flat[key]
        assert tuple(t.shape) == leaf.shape, key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    # the reference's init scales: embed rows ~ d^-0.5, norm scales at 1
    d = cfg.d_model
    assert abs(float(port["embed"]["table"].float().std()) - d ** -0.5) < 0.01
    assert bool((port["final_norm"]["scale"] == 1).all())


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("field,value", [
    ("lanes", 2), ("resources", ("embeddings",)), ("jit_tier_reads", True),
    ("paged", False),
])
def test_engine_refuses_features_not_yet_ported(field, value):
    tcfg = t_registry.get_smoke_config(ARCH)
    scfg = t_engine.ServeConfig(**dict(SCFG, **{field: value}))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_engine.ServeEngine(tcfg, None, scfg, device="cpu")


def test_registry_names_unported_archs():
    assert t_registry.list_archs() == [ARCH]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_registry.get_config("kimi-k2-1t-a32b")
    with pytest.raises(KeyError):
        t_registry.get_config("no-such-arch")
