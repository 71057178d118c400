"""Threefry2x32 counter-based random numbers, bit for bit as ``jax.random``.

The reference samples tokens with ``jax.random`` (``fold_in`` per request
and token, ``categorical`` over the tempered logits); the port draws the
same bits so that a sampled trace replays token for token.  Keys are raw
``(..., 2)`` threefry key pairs held as int64 tensors whose values are
uint32 (torch has no uint32 arithmetic): every sum is masked back to 32
bits, and a shift never carries past bit 62.

The counter layout follows jax with ``jax_threefry_partitionable=True``
(the default since jax 0.5): element ``i`` of a ``random_bits`` call of
``n`` elements hashes the counter pair ``(i >> 32, i & 0xffffffff)`` under
the key and returns the xor of the two output words.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block cipher (20 rounds) on broadcastable uint32
    words held in int64: key ``(k0, k1)``, counters ``(x0, x1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]`` (a
    negative seed is taken modulo 2**32, as jax's int32 cast does)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one raw key (2,): (num, 2), new key
    ``i`` the hash of the counter pair ``(i >> 32, i & 0xffffffff)``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return torch.stack([y0, y1], dim=-1)


def randint(key: torch.Tensor, shape: tuple[int, ...], span: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, span, int32)`` for a power-of-two
    ``span`` <= 2**31: jax draws two words per element from the two halves
    of ``split(key)`` and combines them with a multiplier of
    ``(2**16 % span)**2 % span``, which is 0 for a power of two, so the
    value is the second half's bits masked to ``span - 1``."""
    if span <= 0 or span & (span - 1) or span > 1 << 31:
        raise ValueError(f"span {span} is not a power of two <= 2**31")
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits(split(key)[1:], n)[0] & (span - 1)
    return bits.to(torch.int32).reshape(shape)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``keys`` (..., 2), ``data`` an
    int or a tensor broadcastable to ``keys.shape[:-1]``; the new key is the
    hash of the counter pair ``(0, data)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element: ``keys`` (L, 2) -> (L, n), row ``l`` equal
    to ``jax.random.bits(keys[l], (n,), uint32)`` (a vmap over the keys)."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & MASK32)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = TINY) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)`` per key row:
    the top 23 bits as a mantissa in [1, 2), minus 1, scaled and clamped."""
    bits = random_bits(keys, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(1.0, dtype=torch.float32) - lo
    return torch.maximum(lo.to(keys.device),
                         floats * span.to(keys.device) + lo.to(keys.device))


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32, mode="low")`` per key row:
    ``-log(-log(u))`` with ``u`` uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)`` with the default
    ``replace=True``: the argmax of Gumbel noise plus ``logits`` (L, V),
    the first index on a tie."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
