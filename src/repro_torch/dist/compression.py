"""int8 gradient compression with error feedback (port of
``repro/dist/compression.py``).

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
reciprocal, so payloads are bitwise its eager run's).

:func:`compress_psum` is the cross-rank half: the data-parallel gradient
sum over a process group through the same int8+EF core.
"""
from __future__ import annotations

import torch

from repro_torch.dist.collectives import all_reduce, group_size
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


@torch.no_grad()
def compress_psum(tree, ef, group):
    """int8+EF compressed sum over ``group`` (the data-parallel gradient
    all-reduce under ``TrainConfig.local_grads``) -> (the summed tree, the
    new residuals).

    Each rank quantizes ``g + ef`` per tensor, the dequantized float32
    tensors are summed over the group (on a real fabric the int8 payload
    and one float32 scale a tensor are what the wire carries, see
    :func:`psum_bytes`) and the sum is cast back to each gradient's dtype.
    The residual ``x - applied`` is averaged over the group, so the
    error-feedback state stays replicated: ``n`` times the mean residual is
    the whole unsent signal, and the accumulated sum stays unbiased as in
    :func:`compress_grads`."""
    n = torch.tensor(float(group_size(group)))

    def one(g, e):
        x = g.float() + e
        q, scale = quantize_int8(x)
        applied = dequantize_int8(q, scale, torch.float32)
        total = all_reduce(applied.clone(), group).to(g.dtype)
        return total, all_reduce(x - applied, group) / n.to(x.device)

    out = [one(g, e) for g, e in zip(tree_leaves(tree), tree_leaves(ef))]
    return (tree_unflatten(tree, [o[0] for o in out]),
            tree_unflatten(tree, [o[1] for o in out]))


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
