"""The port's cross attention, encoder and its two archs that need them
(llama-3.2-vision-11b, whisper-base) against the reference, on the CPU at
smoke widths, from the reference's exact weights (``params_from_jax``).
Where the ``cross`` path is under test both trees' gates ``xgate`` are set
to ``GATE``: the reference draws them as zeros, and then an image changes
nothing.

* ``sdpa``, ``sdpa_chunked`` and ``gqa_apply``, bidirectional and causal
  (the latter also with a sliding window and a softcap), at 25 positions
  and at 1,024, which the chunked path splits into 512-query chunks;
  ``cross_apply`` with and without QKV biases: float32 within 1e-5.
* ``encode`` (whisper-smoke, 25 frames): float32 within 1e-5 (in bf16 the
  engine test below holds its output bitwise).
* ``decode_step(aux_embeds=)`` of both archs, float32, 12 teacher-forced
  steps: logits within 1e-4, K/V rows within 1e-5, and the aux embeddings
  change the logits.  ``prefill_dense(aux_embeds=)`` in bf16: the last
  logits within the reference's decode-parity bound DECODE_PARITY
  (``tests/test_models.py:74``), and equal to streaming ``decode_step``.
* ROADMAP C6: ``decode_step_paged`` on llama-3.2-vision-smoke equals the
  reference's paged step (logits within 1e-4) with the gates at 0 and at
  ``GATE``, and the gates change nothing on the ring, which has no cross
  step, while they do on the dense path.
* ``ServeEngine.generate(prompt, n, aux_embeds=)`` in dense mode with the
  embeddings resource, bf16: greedy tokens, whisper's encoder output, the
  embeddings ``TierStats`` integers and placement table bitwise against
  the reference's engine run in one subprocess with XLA's excess precision
  off; ``reference_rounding`` (``tests/test_torch_dense.py``) swaps in the
  reference's SiLU and tanh GELU op by op (ROADMAP C2).
"""
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

import repro.dist.host_offload as ho  # noqa: E402
from repro.configs.registry import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode as j_dec  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax, sketch_seeds_from_jax  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from test_torch_dense import reference_rounding  # noqa: E402,F401

VISION, WHISPER = "llama-3.2-vision-11b", "whisper-base"
ARCHS = (VISION, WHISPER)
GATE = 0.5
DECODE_PARITY = 0.25    # the reference's decode-parity bound (tests/test_models.py:74)
B, STEPS, PROMPT, NEW = 2, 12, 12, 8
SCFG = dict(max_seq=32, resources=("embeddings",), embed_hot_slots=4,
            embed_rows_per_page=8, migration_interval=4)
INT_STATS = ("fast_reads", "slow_reads", "promoted", "demoted", "ping_pong",
             "migration_bytes", "last_epoch_bytes", "max_epoch_bytes",
             "quota_bytes", "migration_epochs", "flush_bytes", "inflight_bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor runs slow down many-fold when each worker
    also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def device_tier_probe(monkeypatch):
    """Keep the reference's slow tier a device array on the CPU backend
    (ROADMAP C0)."""
    monkeypatch.setitem(ho._probe_cache, "kinds", ("device",))


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)


def _gated(params, gate):
    """The reference's params with every ``cross`` block's gate at ``gate``."""
    blocks = [dict(b, xgate=jnp.full_like(b["xgate"], gate)) if "xgate" in b else b
              for b in params["blocks"]]
    return dict(params, blocks=blocks)


def _trees(arch, gate=GATE, f32=True, seed=0):
    """(reference params, port params) of ``arch``'s smoke config."""
    jp = j_tr.init_params(j_smoke(arch), jax.random.PRNGKey(seed))
    jp = _gated(_f32(jp) if f32 else jp, gate)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _aux(cfg, seed=3):
    """(B, n_aux_tokens, d) float32 aux embeddings from a numpy seed."""
    return np.random.default_rng(seed).normal(
        0, 1, (B, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# -- full-sequence attention and cross attention -------------------------------

ATTN = dict(h=4, hkv=2, dh=16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn", ["sdpa", "sdpa_chunked", "gqa_apply"])
def test_full_sequence_attention_matches_reference(fn, causal):
    """25 positions take the plain path, 1,024 two chunks of 512 (the
    causal chunks also with a sliding window of 300, which slices the keys,
    and a softcap)."""
    rng = np.random.default_rng(0)
    d = 32
    p = j_attn.gqa_init(jax.random.PRNGKey(1), d, **ATTN, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    cases = [dict(causal=causal)]
    if causal:
        cases.append(dict(causal=True, window=300, softcap=30.0))
    for s in (25, 1024):
        x = rng.normal(0, 1, (1, s, d)).astype(np.float32)
        q = rng.normal(0, 1, (1, s, ATTN["h"], ATTN["dh"])).astype(np.float32)
        k, v = (rng.normal(0, 1, (1, s, ATTN["hkv"], ATTN["dh"])).astype(np.float32)
                for _ in range(2))
        for kw in cases:
            if fn == "gqa_apply":
                want = j_attn.gqa_apply(p, jnp.asarray(x), **ATTN, **kw)
                got = t_attn.gqa_apply(tp, torch.from_numpy(x), **ATTN, **kw)
            else:
                want = getattr(j_attn, fn)(*map(jnp.asarray, (q, k, v)), **kw)
                got = getattr(t_attn, fn)(*map(torch.from_numpy, (q, k, v)), **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                       rtol=0, err_msg=f"{fn} S={s} {kw}")


def test_chunked_path_splits_long_sequences(monkeypatch):
    """A multiple of CHUNK_Q above it runs in chunks; whisper's 1,500 frames
    (not a multiple) and anything up to CHUNK_Q take the plain path."""
    calls = []
    plain = t_attn.sdpa
    monkeypatch.setattr(t_attn, "sdpa", lambda *a, **kw: calls.append(a[0].shape[1])
                        or plain(*a, **kw))
    for s in (1024, 1500, 512):
        x = torch.zeros((1, s, 2, 4))
        t_attn.sdpa_chunked(x, x[:, :, :1], x[:, :, :1])
    assert calls == [512, 512, 1500, 512]


@pytest.mark.parametrize("bias", [False, True])
def test_cross_apply_matches_reference(bias):
    rng = np.random.default_rng(2)
    d = 32
    p = j_attn.gqa_init(jax.random.PRNGKey(2), d, **ATTN, bias=bias, dtype=jnp.float32)
    if bias:
        p = {k: (jnp.asarray(rng.normal(0, 0.5, v.shape), jnp.float32)
                 if k.startswith("b") else v) for k, v in p.items()}
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    x = rng.normal(0, 1, (B, 3, d)).astype(np.float32)
    src = rng.normal(0, 1, (B, 17, d)).astype(np.float32)
    want = j_attn.cross_apply(p, jnp.asarray(x), jnp.asarray(src), **ATTN)
    got = t_attn.cross_apply(tp, torch.from_numpy(x), torch.from_numpy(src), **ATTN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# -- the encoder ----------------------------------------------------------------

def test_encode_matches_reference():
    """float32; in bf16 the engine test holds it bitwise to the flag-off
    reference."""
    cfg, tcfg = j_smoke(WHISPER), t_registry.get_smoke_config(WHISPER)
    assert cfg.n_aux_tokens == 25
    frames = _aux(cfg)
    jp, tp = _trees(WHISPER)
    want = np.asarray(j_tr.encode(cfg, jp, jnp.asarray(frames)))
    got = t_tr.encode(tcfg, tp, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- decode over aux embeddings ---------------------------------------------------

def _aux_pair(arch, cfg, jp, tp, dt=jnp.float32):
    """The aux embeddings each package's decode takes: the patches, or
    whisper's frames through each package's own encoder."""
    raw = jnp.asarray(_aux(cfg), dt)
    traw = torch.from_numpy(np.array(raw.astype(jnp.float32))).to(
        torch.float32 if dt == jnp.float32 else torch.bfloat16)
    if not cfg.encoder_layers:
        return raw, traw
    return j_tr.encode(cfg, jp, raw), t_tr.encode(
        t_registry.get_smoke_config(arch), tp, traw)


def _teacher_tokens(vocab):
    return np.random.default_rng(7).integers(0, vocab, (STEPS, B, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_with_aux_matches_reference(arch):
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jp, tp = _trees(arch)
    jaux, taux = _aux_pair(arch, cfg, jp, tp)
    jc = j_dec.init_cache(cfg, B, 16, dtype=jnp.float32)
    tc = t_dec.init_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    bare = t_dec.init_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, c, t, a: j_dec.decode_step(cfg, p, c, t, aux_embeds=a))
    moved = 0.0
    for i, tok in enumerate(_teacher_tokens(cfg.vocab)):
        jl, jc = step(jp, jc, jnp.asarray(tok), jaux)
        tl, tc = t_dec.decode_step(tcfg, tp, tc, torch.from_numpy(tok), aux_embeds=taux)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"{arch} logits step {i}")
        bl, bare = t_dec.decode_step(tcfg, tp, bare, torch.from_numpy(tok))
        moved = max(moved, float((tl - bl).abs().max()))
    assert moved > 1e-2          # the cross blocks read the aux embeddings
    for got, want in zip(tc["blocks"], jc["blocks"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), atol=1e-5,
                                       rtol=0, err_msg=f"{arch} cache {k}")
    assert int(tc["pos"]) == int(jc["pos"]) == STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_dense_with_aux_matches_reference(arch):
    """bf16 (the reference's init): the last logits within DECODE_PARITY of
    the reference's, and the port's prefill equal to streaming decode
    steps."""
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jp, tp = _trees(arch, f32=False)
    jaux, taux = _aux_pair(arch, cfg, jp, tp, jnp.bfloat16)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    jl, _, _ = jax.jit(lambda p, c, t, a: j_dec.prefill_dense(cfg, p, c, t, aux_embeds=a))(
        jp, j_dec.init_cache(cfg, B, 16), jnp.asarray(toks), jaux)
    c1 = t_dec.init_cache(tcfg, B, 16, device="cpu")
    last, c1, _ = t_dec.prefill_dense(tcfg, tp, c1, torch.from_numpy(toks).long(),
                                      aux_embeds=taux)
    assert float(np.abs(last.numpy() - np.asarray(jl)).max()) < DECODE_PARITY
    c2 = t_dec.init_cache(tcfg, B, 16, device="cpu")
    for col in range(PROMPT):
        logits, c2 = t_dec.decode_step(tcfg, tp, c2, torch.from_numpy(toks[:, col:col + 1]),
                                       aux_embeds=taux)
    assert torch.equal(last, logits[:, -1])
    for a, b in zip(c1["blocks"], c2["blocks"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


# -- ROADMAP C6: the paged path has no cross step --------------------------------------

@pytest.mark.parametrize("gate", [0.0, GATE])
def test_decode_step_paged_drops_cross_attention(gate):
    """The ring's step equals the reference's at either gate, and reads no
    gate: the logits at ``gate`` are bitwise those at 0.  The dense path
    with aux embeddings does read it."""
    arch = VISION
    cfg, tcfg = j_smoke(arch), t_registry.get_smoke_config(arch)
    jp, tp = _trees(arch, gate)
    _, shut = _trees(arch, 0.0)
    page_t, slots = 4, 4
    jc = j_dec.init_paged_cache(cfg, B, slots, page_t, dtype=jnp.float32)
    tc, tc0 = (t_dec.init_paged_cache(tcfg, B, slots, page_t, dtype=torch.float32,
                                      device="cpu") for _ in range(2))
    step = jax.jit(lambda p, c, t: j_dec.decode_step_paged(cfg, p, c, t, page_t=page_t))
    for i, tok in enumerate(_teacher_tokens(cfg.vocab)):
        jl, jc = step(jp, jc, jnp.asarray(tok))
        tl, tc = t_dec.decode_step_paged(tcfg, tp, tc, torch.from_numpy(tok), page_t=page_t)
        tl0, tc0 = t_dec.decode_step_paged(tcfg, shut, tc0, torch.from_numpy(tok),
                                           page_t=page_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0,
                                   err_msg=f"logits step {i}")
        assert torch.equal(tl, tl0), i
    taux = torch.from_numpy(_aux(cfg))
    tok = torch.from_numpy(_teacher_tokens(cfg.vocab)[0])
    dense = [t_dec.decode_step(tcfg, p, t_dec.init_cache(tcfg, B, 4, torch.float32,
                                                         device="cpu"),
                               tok, aux_embeds=taux)[0] for p in (tp, shut)]
    assert torch.equal(dense[0], dense[1]) == (gate == 0.0)


# -- the engine in dense mode --------------------------------------------------------

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
import repro.dist.host_offload as ho
ho._probe_cache["kinds"] = ("device",)   # ROADMAP C0
from repro.configs.registry import get_smoke_config
from repro.models import transformer as tr
from repro.serve.engine import ServeConfig, ServeEngine
archs, out, scfg, gate, b, n, new = (json.loads(sys.argv[1]), sys.argv[2],
                                     json.loads(sys.argv[3]), float(sys.argv[4]),
                                     *map(int, sys.argv[5:8]))
res, stats = {}, {}
for arch in archs:
    cfg = get_smoke_config(arch)
    params = tr.init_params(cfg, jax.random.PRNGKey(0))
    params["blocks"] = [dict(p, xgate=jnp.full_like(p["xgate"], gate))
                        if "xgate" in p else p for p in params["blocks"]]
    prompt = np.random.default_rng(n).integers(0, cfg.vocab, (b, n)).astype(np.int32)
    aux = np.random.default_rng(3).normal(
        0, 1, (b, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)
    eng = ServeEngine(cfg, params, ServeConfig(**scfg))
    res[f"{arch}/tokens"] = eng.generate(prompt, new, jnp.asarray(aux, jnp.bfloat16))
    res[f"{arch}/aux"] = np.asarray(eng.aux.astype(jnp.float32))
    h = eng.daemon["embeddings"]
    res[f"{arch}/seeds"] = np.asarray(h.state.prof.sketch.seeds)
    res[f"{arch}/page_slot"] = np.asarray(h.state.tier.page_slot)
    stats[arch] = {"row": eng.tier_stats()["embeddings"], "steps": eng.step_count}
np.savez(out + ".npz", **res)
json.dump(stats, open(out + ".json", "w"))
"""


@pytest.fixture(scope="module")
def engine_reference(tmp_path_factory):
    """The reference engine's dense-mode runs of both archs, in one
    subprocess with XLA's excess precision off (see the module docstring)."""
    root = Path(__file__).resolve().parents[1]
    out = str(tmp_path_factory.mktemp("cross_ref") / "ref")
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
    env = dict(os.environ, XLA_FLAGS=flags.strip(), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(ARCHS), out, json.dumps(SCFG),
         str(GATE), str(B), str(PROMPT), str(NEW)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out + ".npz")), json.load(open(out + ".json"))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_with_aux_matches_reference(arch, engine_reference,
                                                    reference_rounding):
    ref, stats = engine_reference
    want = stats[arch]
    cfg = j_smoke(arch)
    jp = _gated(j_tr.init_params(cfg, jax.random.PRNGKey(0)), GATE)
    te = t_engine.ServeEngine(
        t_registry.get_smoke_config(arch),
        params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
        t_engine.ServeConfig(**SCFG), device="cpu",
        sketch_seeds=sketch_seeds_from_jax(ref[f"{arch}/seeds"]))
    prompt = np.random.default_rng(PROMPT).integers(0, cfg.vocab, (B, PROMPT))
    aux = np.asarray(jnp.asarray(_aux(cfg), jnp.bfloat16))   # numpy bf16, as served
    np.testing.assert_array_equal(te.generate(prompt.astype(np.int32), NEW, aux),
                                  ref[f"{arch}/tokens"])
    np.testing.assert_array_equal(_np(te.aux), ref[f"{arch}/aux"])
    assert te.aux.dtype == torch.bfloat16
    assert tuple(te.aux.shape) == (B, cfg.n_aux_tokens, cfg.d_model)
    row = te.tier_stats()["embeddings"]
    assert {k: row[k] for k in INT_STATS} == {k: want["row"][k] for k in INT_STATS}
    assert te.step_count == want["steps"] == PROMPT + NEW - 1
    np.testing.assert_array_equal(te.daemon["embeddings"].state.tier.page_slot.numpy(),
                                  ref[f"{arch}/page_slot"])


def test_check_ported_binds_cross_kinds_to_their_families():
    """``cross`` runs in the vision family and ``dec`` behind an encoder in
    the encoder-decoder family; neither family takes the other's kinds,
    experts, MLA, or (for vision) an encoder."""
    import dataclasses
    vision, whisper = (t_registry.get_smoke_config(a) for a in ARCHS)
    for ok in (vision, whisper, dataclasses.replace(vision, pattern=("attn",))):
        t_tr.check_ported(ok)
    llama = t_registry.get_smoke_config("llama3.2-3b")
    for bad in (dataclasses.replace(vision, pattern=("attn", "dec")),
                dataclasses.replace(vision, encoder_layers=1, n_layers=6),
                dataclasses.replace(vision, mla=t_registry.get_config(
                    "deepseek-v3-671b").mla),
                dataclasses.replace(whisper, pattern=("dec", "cross"), n_layers=6),
                dataclasses.replace(whisper, encoder_layers=0, n_layers=2),
                dataclasses.replace(llama, family="vlm", pattern=("attn", "mamba"))):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_tr.check_ported(bad)
    tree = t_tr.init_params(vision, device="cpu")
    gate = tree["blocks"][vision.pattern.index("cross")]["xgate"]
    assert gate.dtype == torch.float32 and tuple(gate.shape) == (vision.n_groups, 1)
    assert not bool(gate.any())                 # drawn as zeros, as the reference's
