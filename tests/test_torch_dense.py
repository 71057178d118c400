"""The port's dense-cache serving mode (``ServeConfig.paged=False``, the
reference's default) against the reference, on the CPU at smoke widths,
from the reference's exact weights (``params_from_jax``) and H3 seeds.

* ``gqa_decode`` (causal mask, sliding window, softcap, query scale, QKV
  biases) and ``mla_decode`` (the absorbed latent decode), float32: outputs
  within 1e-5 and the written cache rows exact up to float32 rounding.
* ``init_cache``'s layout for every ported arch; ``prefill_dense`` equal
  to token-at-a-time ``decode_step`` calls and, in float32, to the
  reference's (logits within 1e-4, the (S, G, n_moe, B, 1, k) router
  stream bitwise).
* The engine in dense mode against ``repro.serve.engine.ServeEngine`` for
  llama3.2-3b, qwen1.5-4b and gemma2-27b with the embeddings resource, bf16:
  greedy tokens bitwise and the embeddings ``TierStats`` integers, the
  placement table and the θ trace equal.  The reference runs in a
  subprocess with XLA's excess precision off, and ``reference_rounding``
  swaps the port's ``F.silu`` and ``F.gelu`` for the reference's formulas
  op by op (ROADMAP C2).
* The port's twin of ``tests/test_prefill_chunked.py::
  test_dense_prefill_matches_paged``; the default ``ServeConfig()`` serving
  every ported arch; the reference's ``ValueError``s.
* gemma2's window: the dense path masks keys ``window`` (8 at smoke) or
  more positions back on its ``attn_local`` layers; the paged path does
  not, as the reference's does not (ROADMAP C5).
"""
import dataclasses
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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

ARCHS = tuple(t_registry.ARCHS)
ENGINE_ARCHS = ("llama3.2-3b", "qwen1.5-4b", "gemma2-27b")
B, PROMPT, NEW = 2, 20, 16
DENSE_SCFG = dict(max_seq=64, resources=("embeddings",), embed_hot_slots=4,
                  embed_rows_per_page=8, migration_interval=4)
INT_STATS = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
             "migration_bytes", "last_epoch_bytes", "max_epoch_bytes",
             "quota_bytes", "migration_epochs", "flush_bytes", "inflight_bytes")


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _prompt(vocab, seed=PROMPT):
    return np.random.default_rng(seed).integers(0, vocab, (B, PROMPT)).astype(np.int32)


# -- attention over the full cache ---------------------------------------------

GQA_CASES = {   # h, hkv, dh, bias, window, softcap, scale
    "plain": (4, 2, 16, False, 0, 0.0, None),
    "window": (4, 2, 16, False, 5, 0.0, None),
    "softcap-scale": (4, 2, 16, False, 0, 50.0, 0.2),
    "bias-group1": (4, 4, 16, True, 0, 0.0, None),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_decode_matches_reference(case):
    h, hkv, dh, bias, window, softcap, scale = GQA_CASES[case]
    d, smax, pos = 48, 16, 9
    p = j_attn.gqa_init(jax.random.PRNGKey(1), d, h, hkv, dh, bias=bias,
                        dtype=jnp.float32)
    rng = np.random.default_rng(2)
    if bias:
        for k in ("bq", "bk", "bv"):
            p[k] = jnp.asarray(rng.normal(0, 0.2, p[k].shape), jnp.float32)
    cache = {k: rng.normal(0, 1, (B, smax, hkv, dh)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.normal(0, 1, (B, 1, d)).astype(np.float32)
    kw = dict(h=h, hkv=hkv, dh=dh, rope_theta=10000.0, window=window,
              softcap=softcap, scale=scale)
    want, jc = j_attn.gqa_decode(p, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                                 jnp.int32(pos), **kw)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = t_attn.gqa_decode(params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
                            torch.from_numpy(x), tc,
                            torch.tensor(pos, dtype=torch.int32), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-6, rtol=0)


def test_mla_decode_matches_reference():
    cfg = j_smoke("deepseek-v3-671b")
    m = dataclasses.asdict(cfg.mla)
    d, smax, pos = cfg.d_model, 12, 7
    p = j_attn.mla_init(jax.random.PRNGKey(4), d, cfg.n_heads, dtype=jnp.float32, **m)
    rng = np.random.default_rng(5)
    cache = {"c_kv": rng.normal(0, 1, (B, smax, m["kv_lora"])).astype(np.float32),
             "k_rope": rng.normal(0, 1, (B, smax, m["d_rope"])).astype(np.float32)}
    x = rng.normal(0, 1, (B, 1, d)).astype(np.float32)
    want, jc = j_attn.mla_decode(p, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                                 jnp.int32(pos), h=cfg.n_heads,
                                 rope_theta=cfg.rope_theta, **m)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = t_attn.mla_decode(params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
                            torch.from_numpy(x), tc, torch.tensor(pos, dtype=torch.int32),
                            h=cfg.n_heads, rope_theta=cfg.rope_theta, **m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for k in cache:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-6, rtol=0)


# -- the dense cache and prefill -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    ref = j_dec.init_cache(j_smoke(arch), B, 24)
    port = t_dec.init_cache(t_registry.get_smoke_config(arch), B, 24, device="cpu")
    assert set(port) == set(ref)
    assert port["pos"].shape == () and port["pos"].dtype == torch.int32
    pairs = list(zip(port["blocks"], ref["blocks"])) + list(
        zip(port.get("prologue", []), ref.get("prologue", [])))
    assert len(pairs) == len(ref["blocks"]) + len(ref.get("prologue", []))
    for got, want in pairs:
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "gemma2-27b"])
def test_prefill_dense_matches_reference_and_streaming(arch):
    """float32: the last logits within 1e-4 of the reference's, the router
    stream bitwise (its (S, G, n_moe, B, 1, k) layout is what the experts
    resource numbers by column, ROADMAP C4), and the port's prefill equal
    to token-at-a-time decode steps."""
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jp = _f32(j_tr.init_params(cfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _prompt(cfg.vocab)[:, :11]
    jl, _, js = jax.jit(lambda p, c, t: j_dec.prefill_dense(cfg, p, c, t))(
        jp, j_dec.init_cache(cfg, B, 16, jnp.float32), jnp.asarray(toks))
    c1 = t_dec.init_cache(tcfg, B, 16, torch.float32, device="cpu")
    last, c1, ts = t_dec.prefill_dense(tcfg, tp, c1, torch.from_numpy(toks).long())
    np.testing.assert_allclose(last.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    if js["router"] is None:
        assert ts["router"] is None
    else:
        assert tuple(ts["router"].shape) == (11, tcfg.n_groups, 1, B, 1, tcfg.moe.top_k)
        np.testing.assert_array_equal(ts["router"].numpy(), np.asarray(js["router"]))
    c2 = t_dec.init_cache(tcfg, B, 16, torch.float32, device="cpu")
    for col in range(toks.shape[1]):
        logits, c2 = t_dec.decode_step(tcfg, tp, c2, torch.from_numpy(toks[:, col:col + 1]))
    assert torch.equal(last, logits[:, -1])
    for a, b in zip(c1["blocks"], c2["blocks"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(c1["pos"]) == int(c2["pos"]) == 11


# -- gemma2's sliding window ----------------------------------------------------

def test_gemma2_window_masks_the_dense_path_only():
    """Teacher-forced float32 steps through the port's dense and paged paths
    (a ring that holds every token): equal while every key is within the
    window of 8, apart from step 8 on (the dense local layers drop the
    oldest keys), each equal to the reference's path within 1e-4."""
    arch = "gemma2-27b"
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    assert cfg.window == 8 and cfg.pattern == ("attn_local", "attn_global")
    jp = _f32(j_tr.init_params(cfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    dense = t_dec.init_cache(tcfg, B, 16, torch.float32, device="cpu")
    paged = t_dec.init_paged_cache(tcfg, B, 4, 4, torch.float32, device="cpu")
    jd = j_dec.init_cache(cfg, B, 16, jnp.float32)
    jpg = j_dec.init_paged_cache(cfg, B, 4, 4, jnp.float32)
    jstep = jax.jit(lambda p, c, t: j_dec.decode_step(cfg, p, c, t))
    jpaged = jax.jit(lambda p, c, t: j_dec.decode_step_paged(cfg, p, c, t, page_t=4))
    toks = _prompt(cfg.vocab)[:, :12, None]
    for step in range(12):
        tok = toks[:, step]
        ld, dense = t_dec.decode_step(tcfg, tp, dense, torch.from_numpy(tok))
        lp, paged = t_dec.decode_step_paged(tcfg, tp, paged, torch.from_numpy(tok),
                                            page_t=4)
        jld, jd = jstep(jp, jd, jnp.asarray(tok))
        jlp, jpg = jpaged(jp, jpg, jnp.asarray(tok))
        np.testing.assert_allclose(ld.numpy(), np.asarray(jld), atol=1e-4, rtol=0)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=0)
        gap = float((ld - lp).abs().max())
        if step < cfg.window:
            assert gap < 1e-4, (step, gap)
        else:
            assert gap > 1e-3, (step, gap)


# -- the engine in dense mode -------------------------------------------------------

_REFERENCE = """
import json, sys
import numpy as np, jax
import repro.dist.host_offload as ho
ho._probe_cache["kinds"] = ("device",)   # ROADMAP C0
from repro.configs.registry import get_smoke_config
from repro.models import transformer as tr
from repro.serve.engine import ServeConfig, ServeEngine
archs, out, scfg, b, n, new = (json.loads(sys.argv[1]), sys.argv[2],
                               json.loads(sys.argv[3]), *map(int, sys.argv[4:7]))
res, stats = {}, {}
for arch in archs:
    cfg = get_smoke_config(arch)
    params = tr.init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(n).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    eng = ServeEngine(cfg, params, ServeConfig(**scfg))
    res[f"{arch}/tokens"] = eng.generate(prompt, new)
    h = eng.daemon["embeddings"]
    res[f"{arch}/seeds"] = np.asarray(h.state.prof.sketch.seeds)
    res[f"{arch}/page_slot"] = np.asarray(h.state.tier.page_slot)
    stats[arch] = {"row": eng.tier_stats()["embeddings"], "steps": eng.step_count,
                   "theta": h.stats.theta_trace}
np.savez(out + ".npz", **res)
json.dump(stats, open(out + ".json", "w"))
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


@pytest.fixture(scope="module")
def dense_reference(tmp_path_factory):
    """The reference engine's dense-mode runs, in a subprocess with XLA's
    excess precision off (see the module docstring)."""
    root = Path(__file__).resolve().parents[1]
    out = str(tmp_path_factory.mktemp("dense_ref") / "ref")
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(ENGINE_ARCHS), out,
         json.dumps(DENSE_SCFG), str(B), str(PROMPT), str(NEW)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out + ".npz")), json.load(open(out + ".json"))


def _silu_op_by_op(x):
    """``jax.nn.silu``'s formula, rounding after every op in x's dtype."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu_op_by_op(x, approximate="none"):
    """``jax.nn.gelu(x, approximate=True)``'s formula, rounding after every
    op in x's dtype, its two constants rounded to x's dtype first as JAX's
    weakly typed constants are."""
    assert approximate == "tanh"
    c0 = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype)
    c1 = torch.tensor(0.044715, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * x * x))))
    return x * cdf


@pytest.fixture
def reference_rounding(monkeypatch):
    """Round swiglu's and geglu's activations where the flag-off reference
    rounds."""
    monkeypatch.setattr(t_layers.F, "silu", _silu_op_by_op)
    monkeypatch.setattr(t_layers.F, "gelu", _gelu_op_by_op)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_dense_generate_matches_reference(arch, dense_reference,
                                                 reference_rounding):
    ref, stats = dense_reference
    want = stats[arch]
    cfg = j_smoke(arch)
    te = t_engine.ServeEngine(
        t_registry.get_smoke_config(arch),
        params_from_jax(jax.tree.map(np.asarray,
                                     j_tr.init_params(cfg, jax.random.PRNGKey(0))),
                        device="cpu"),
        t_engine.ServeConfig(**DENSE_SCFG), device="cpu",
        sketch_seeds=sketch_seeds_from_jax(ref[f"{arch}/seeds"]))
    assert "kv" not in te.daemon
    np.testing.assert_array_equal(te.generate(_prompt(cfg.vocab), NEW),
                                  ref[f"{arch}/tokens"])
    row = te.tier_stats()["embeddings"]
    assert {k: row[k] for k in INT_STATS} == {k: want["row"][k] for k in INT_STATS}
    assert row["migration_bytes"] > 0
    assert te.step_count == want["steps"] == PROMPT + NEW - 1
    h = te.daemon["embeddings"]
    np.testing.assert_array_equal(h.state.tier.page_slot.numpy(),
                                  ref[f"{arch}/page_slot"])
    assert h.stats.theta_trace == want["theta"]


def test_dense_prefill_matches_paged():
    """The twin of the reference's parity gate: dense prefill and decode
    give the paged engine's tokens (a 64-token ring holds the whole run)."""
    tcfg = t_registry.get_smoke_config("llama3.2-3b")
    cfg = j_smoke("llama3.2-3b")
    params = params_from_jax(jax.tree.map(
        np.asarray, j_tr.init_params(cfg, jax.random.PRNGKey(0))), device="cpu")
    prompt = (np.arange(2 * 12).reshape(2, 12) * 7 % cfg.vocab).astype(np.int32)
    dense = t_engine.ServeEngine(tcfg, params, t_engine.ServeConfig(max_seq=64),
                                 device="cpu")
    paged = t_engine.ServeEngine(tcfg, params, t_engine.ServeConfig(
        max_seq=64, paged=True, page_t=4, hot_slots=16, migration_interval=4),
        device="cpu")
    np.testing.assert_array_equal(dense.generate(prompt, n_tokens=8),
                                  paged.generate(prompt, n_tokens=8))


@pytest.mark.parametrize("arch", ARCHS)
def test_default_serve_config_serves(arch):
    """``ServeConfig()`` is dense with no resource: one prefill pass, then
    decode steps over the 4096-position cache; no daemon tick runs."""
    tcfg = t_registry.get_smoke_config(arch)
    eng = t_engine.ServeEngine(tcfg, t_tr.init_params(tcfg, seed=0, device="cpu"),
                               t_engine.ServeConfig(), device="cpu")
    out = eng.generate(_prompt(tcfg.vocab)[:, :8], 4)
    assert out.shape == (B, 4) and (out >= 0).all() and (out < tcfg.vocab).all()
    attn = [e for e in eng.cache["blocks"] if "k" in e or "c_kv" in e]
    assert all(next(iter(e.values())).shape[2] == 4096 for e in attn)
    assert bool(attn) == (tcfg.family != "ssm")        # xlstm has no attention
    assert int(eng.cache["pos"]) == 8 + 3 and eng.step_count == 11
    assert not eng.daemon.resources


@pytest.mark.parametrize("field,value,match", [
    ("lanes", 2, "lane mode .* requires paged=True"),
    ("resources", ("kv",), "'kv' resource requires paged=True"),
])
def test_dense_mode_refusals_match_reference(field, value, match):
    tcfg = t_registry.get_smoke_config("llama3.2-3b")
    with pytest.raises(ValueError, match=match):
        t_engine.ServeEngine(tcfg, t_tr.init_params(tcfg, seed=0, device="cpu"),
                             t_engine.ServeConfig(**{field: value}), device="cpu")
