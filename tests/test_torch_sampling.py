"""The port's threefry sampler against ``jax.random`` and the reference's
``sample_tokens``, on the CPU.

* Keys (``PRNGKey``, ``fold_in``, ``fold_lane_keys``), ``random_bits`` and
  ``uniform`` are bitwise jax's, over many seeds and shapes, V = 128256
  (llama3.2-3b's vocabulary) among them.
* ``gumbel`` within 2 float32 ulp of ``max(|g|, 1)``: the two ``log``
  implementations (XLA's and PyTorch's) differ by an ulp, and the outer
  log carries the inner one's absolute error, so near g = 0 only an
  absolute bound is meaningful.
* ``sample_tokens`` gives the reference's tokens on seeded logits over a
  grid of temperatures and top-p values, and its top-p keep mask equals
  the reference's except within 1e-6 of the top_p boundary (softmax and
  cumsum round differently).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decode as j_dec  # noqa: E402
from repro_torch.models import decode as t_dec  # noqa: E402
from repro_torch.models import prng  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and these small-tensor runs slow down many-fold when each worker
    also spreads every op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -1, -123456]
VOCAB = 128256


def _jkey(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_bitwise(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(), _jkey(seed))
    data = [0, 1, 2, 5, 1000, 2 ** 31 + 3, 2 ** 32 - 1]
    want = np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), d))) for d in data])
    got = prng.fold_in(prng.prng_key(seed)[None].expand(len(data), 2),
                       torch.as_tensor(data, dtype=torch.int64))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_fold_lane_keys_bitwise():
    """The scheduler's per-lane derivation: request keys folded from (seed,
    rid), then with each lane's emitted-token index."""
    rng = np.random.default_rng(0)
    for seed in SEEDS[:4]:
        rids, idx = rng.integers(0, 500, 6), rng.integers(0, 300, 6)
        jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), int(r))
                           for r in rids])
        want = np.asarray(j_dec.fold_lane_keys(jkeys, jnp.asarray(idx, jnp.uint32)))
        master = prng.prng_key(seed)
        tkeys = torch.stack([prng.fold_in(master, int(r)) for r in rids])
        got = t_dec.fold_lane_keys(tkeys, torch.as_tensor(idx))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097, VOCAB])
def test_random_bits_and_uniform_bitwise(n):
    keys = torch.stack([prng.prng_key(s) for s in SEEDS])
    bits = prng.random_bits(keys, n).numpy()
    uni = prng.uniform(keys, n).numpy()
    tiny = jnp.finfo(jnp.float32).tiny
    for i, seed in enumerate(SEEDS):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.bits(k, (n,), jnp.uint32)).astype(np.int64)
        assert np.array_equal(bits[i], want), seed
        want_u = np.asarray(jax.random.uniform(k, (n,), jnp.float32, tiny, 1.0))
        assert np.array_equal(uni[i], want_u), seed


def test_gumbel_within_two_ulp():
    keys = torch.stack([prng.prng_key(s) for s in SEEDS])
    got = prng.gumbel(keys, VOCAB).numpy()
    for i, seed in enumerate(SEEDS):
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (VOCAB,),
                                            jnp.float32))
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert np.all(np.abs(got[i] - want) <= 2 * ulp), seed


def _logits(seed, lanes=4, vocab=VOCAB):
    """Seeded logits shaped like a model's: a few strong candidates over a
    broad tail."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=2.0, size=(lanes, vocab)).astype(np.float32)
    top = rng.integers(0, vocab, (lanes, 8))
    np.put_along_axis(x, top, rng.normal(8.0, 1.0, (lanes, 8)).astype(np.float32),
                      axis=1)
    return x


@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("temperature", [0.0, 0.5, 0.8, 1.3])
def test_sample_tokens_matches_reference(temperature, top_p):
    """Tokens equal over 6 seeded (4, 128256) logit sets."""
    for s in range(6):
        logits = _logits(s)
        jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), r)
                           for r in range(4)])
        want = np.asarray(j_dec.sample_tokens(jnp.asarray(logits), jkeys,
                                              temperature=temperature,
                                              top_p=top_p))
        tkeys = torch.as_tensor(np.array(jax.random.key_data(jkeys)),
                                dtype=torch.int64)
        got = t_dec.sample_tokens(torch.from_numpy(logits), tkeys,
                                  temperature=temperature, top_p=top_p)
        assert np.array_equal(got.numpy(), want), (s, got, want)


@functools.partial(jax.jit, static_argnames=("temperature", "top_p"))
def _j_keep(logits, *, temperature, top_p):
    """The reference's nucleus arithmetic (``sample_tokens``' own lines):
    the keep mask over the logits and the mass before each token."""
    scaled = logits.astype(jnp.float32) / temperature
    desc = jnp.sort(scaled, axis=-1)[..., ::-1]
    probs = jax.nn.softmax(desc, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = cum - probs < top_p
    cutoff = jnp.min(jnp.where(keep, desc, jnp.inf), axis=-1, keepdims=True)
    order = jnp.argsort(-scaled, axis=-1)
    rows = jnp.arange(scaled.shape[0])[:, None]
    return scaled >= cutoff, jnp.zeros_like(cum).at[rows, order].set(cum - probs)


@pytest.mark.parametrize("top_p", [0.9, 0.5])
@pytest.mark.parametrize("temperature", [0.5, 1.3])
def test_top_p_keep_mask_equal_off_the_boundary(temperature, top_p):
    """The port's kept set (the tokens ``nucleus_logits`` leaves finite)
    equals the reference's, except for tokens whose preceding mass lies
    within 1e-6 of top_p."""
    logits = _logits(11, lanes=3, vocab=4096)
    want, before = (np.asarray(a) for a in _j_keep(jnp.asarray(logits),
                                                  temperature=temperature,
                                                  top_p=top_p))
    got = torch.isfinite(t_dec.nucleus_logits(
        torch.from_numpy(logits), temperature=temperature, top_p=top_p)).numpy()
    near = np.abs(before - top_p) <= 1e-6
    assert np.array_equal(got[~near], want[~near])
    assert want.sum(axis=1).min() >= 1 and got.sum(axis=1).min() >= 1
