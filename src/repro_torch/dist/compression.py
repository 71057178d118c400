"""int8 gradient compression with error feedback, on one device (port of
``repro/dist/compression.py``, its single-device half).

Per-tensor symmetric quantization, ``scale = max|x| / 127`` and ``q =
round(x / scale)`` as int8: a 4x cut of the float32 gradient's wire bytes,
the software analogue of NeoMem's migration-bandwidth quota on the CXL link.
Error feedback carries each step's quantization residual into the next
step's input, so the accumulated transferred signal is unbiased.

    ef = ef_init(params)                     # float32 residuals, zeros
    qs, ef = compress_grads(grads, ef)       # qs: a tree of packets
    grads = decompress_grads(qs)             # the original dtypes back

The symmetric int8 core is :mod:`repro_torch.tiering.codec`'s, with one
scale per tensor; ``max / 127`` and ``q = round(x / scale)`` divide by
tensors on the data's device, as the reference's source divides (its jitted
step compiles the division by the constant 127 as a product by the float32
reciprocal, so payloads are bitwise its eager run's).  The cross-device
``compress_psum`` belongs to the distribution layer and is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.tiering.codec import dequantize_int8, quantize_int8


def ef_init(params):
    """Zero error-feedback residuals: one float32 buffer per param tensor."""
    return tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)])


def _is_packet(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _compress_leaf(g, e):
    x = g.float() + e
    q, scale = quantize_int8(x)
    # the residual is taken against what the receiver applies, the cast back
    # to the gradient's dtype included, so low-precision gradients stay
    # unbiased; "meta" is a zero-size carrier of that dtype
    packet = {"q": q, "scale": scale,
              "meta": torch.zeros((0,), dtype=g.dtype, device=g.device)}
    return packet, x - dequantize_int8(q, scale, g.dtype).float()


@torch.no_grad()
def compress_grads(grads, ef):
    """-> (a tree of packets {"q", "scale", "meta"}, the new residuals)."""
    out = [_compress_leaf(g, e)
           for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def _packet_walk(qs, fn):
    if _is_packet(qs):
        return fn(qs)
    if isinstance(qs, dict):
        return {k: _packet_walk(v, fn) for k, v in qs.items()}
    return type(qs)(_packet_walk(v, fn) for v in qs)


def decompress_grads(qs):
    """A packet tree back to tensors in their original dtypes."""
    return _packet_walk(qs, lambda t: dequantize_int8(t["q"], t["scale"],
                                                      t["meta"].dtype))


def psum_bytes(tree, compressed: bool) -> int:
    """Wire bytes ONE shard contributes to the DP gradient sum: the int8
    payload and a float32 scale per tensor when compressed, the raw element
    bytes otherwise."""
    return sum(l.numel() + 4 if compressed else l.numel() * l.element_size()
               for l in tree_leaves(tree))


def compressed_bytes(qs) -> int:
    """Wire size of a packet tree (int8 payload + a float32 scale a tensor)."""
    sizes = []
    _packet_walk(qs, lambda t: sizes.append(t["q"].numel() + 4))
    return sum(sizes)
