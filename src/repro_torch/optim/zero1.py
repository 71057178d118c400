"""ZeRO-1: the optimizer state as flat float32 vectors, split evenly over
every rank of the mesh (port of ``repro/optim/zero1.py``).

Adam's m and v are elementwise, so they need no tensor structure: every
param is flattened into one padded 1-D vector, in JAX's flatten order of
the params tree (dict keys sorted, :func:`repro_torch.ckpt.manager.tree_leaves`),
so that the flat layout, and a checkpoint of it, is the reference's.  Over
a mesh of n ranks each rank holds its ``padded / n`` slice of m, v (and
``ef``), at its linear coordinate over all the mesh's axes; without a mesh
n is 1.  The update runs in flat space on the rank's slice, and the delta
goes back to the params through an all-gather of the slices (one
all-gather's worth of bytes a step: ZeRO-1's trade of memory for a
collective), each rank subtracting its params' blocks of it.

``compress_collective`` (DESIGN.md §14) quantizes the flat delta to int8,
one symmetric scale per rank's slice, before that gather; a float32
error-feedback vector ``state["ef"]`` carries the quantization residual
into the next step.  The global-norm clip runs on the gradient tree before
flattening, and the quantization strictly after the flat-space optimizer
math, so m, v and step are bitwise those of the uncompressed update; only
the applied delta differs.

``offload_master`` (DESIGN.md §15): over a mesh on the card, m, v and ef
live in pinned host memory between steps (:func:`offload_opt`), and the
train step promotes them on a side stream while the backward runs
(:func:`fetch_opt`, a :class:`repro_torch.dist.host_offload.Prefetch`).
Without a mesh the move is the identity, as the reference's; on the CPU it
is logical.  The update walks the flat slice a segment at a time, in place,
so that a full-width step holds m, v, ef and one float32 delta and no
flat copy of the gradient or the params.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.dist import collectives as col
from repro_torch.dist import host_offload
from repro_torch.dist.sharding import gather, shard, spec_leaves
from repro_torch.optim.optimizers import (OptConfig, bias_corrections,
                                          clip_by_global_norm, schedule, sqrt)
from repro_torch.tiering.codec import quantize_int8  # noqa: F401  the reference's namespace

CHUNK = 1 << 26        # flat elements an in-place pass takes at a time


@dataclasses.dataclass
class FlatSpec:
    sizes: list
    shapes: list
    like: object        # the params tree's structure (0 for every leaf)
    padded: int


def _n_shards(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _local_range(spec: FlatSpec, mesh) -> tuple[int, int]:
    """(first flat index, length) of the rank's slice."""
    n = _n_shards(mesh)
    size = spec.padded // n
    return (0 if mesh is None else mesh.coord(mesh.axis_names)) * size, size


def flat_spec(params, n_shards: int = 1) -> FlatSpec:
    """The flat layout of a full params tree (shapes only: meta tensors do)."""
    leaves = tree_leaves(params)
    sizes = [math.prod(l.shape) for l in leaves]
    padded = -(-sum(sizes) // n_shards) * n_shards
    return FlatSpec(sizes, [tuple(l.shape) for l in leaves],
                    tree_unflatten(params, [0] * len(leaves)), padded)


def flatten(tree, spec: FlatSpec) -> torch.Tensor:
    leaves = tree_leaves(tree)
    flat = torch.cat([l.float().reshape(-1) for l in leaves])
    return torch.nn.functional.pad(flat, (0, spec.padded - flat.shape[0]))


def unflatten(flat: torch.Tensor, spec: FlatSpec, dtypes=None):
    out, off = [], 0
    for i, (sz, shp) in enumerate(zip(spec.sizes, spec.shapes)):
        leaf = flat[off:off + sz].reshape(shp)
        if dtypes is not None:
            leaf = leaf.to(dtypes[i])
        out.append(leaf)
        off += sz
    return tree_unflatten(spec.like, out)


def zero1_init(params, mesh=None, compress_collective: bool = False,
               offload: bool = False):
    """-> (state {"m", "v", "step"[, "ef"]}, FlatSpec).  ``params`` is the
    full tree (its shapes and device are read); each vector is the rank's
    slice, in pinned host memory with ``offload`` over a mesh on the card."""
    spec = flat_spec(params, _n_shards(mesh))
    dev = mesh.device if mesh is not None else tree_leaves(params)[0].device
    size = _local_range(spec, mesh)[1]
    host = offload and mesh is not None and host_offload.supports_memory_kinds(dev)
    z = lambda: (host_offload.pinned_zeros((size,), torch.float32) if host
                 else torch.zeros((size,), dtype=torch.float32, device=dev))
    state = {"m": z(), "v": z(),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if compress_collective:
        state["ef"] = z()
    return state, spec


def offload_opt(state, mesh=None, into=None):
    """Demote the master vectors (m, v, ef; not the step) to the slow tier,
    into ``into``'s pinned tensors where given (the state they were
    fetched from).  The identity without a mesh."""
    if mesh is None:
        return state
    into = into or {}
    return {k: (v if k == "step" else
                host_offload.to_slow_tier(v, mesh, (mesh.axis_names,), out=into.get(k)))
            for k, v in state.items()}


def fetch_opt(state, mesh=None) -> host_offload.Prefetch:
    """Start promoting the master vectors back to the device: issue it
    before the gradient computation and call ``wait()`` before the update,
    so that the host-to-device copies overlap the backward."""
    return host_offload.Prefetch(state, mesh)


def compress_delta(delta: torch.Tensor, ef: torch.Tensor, n_shards: int = 1):
    """int8-quantize the flat delta per shard with error feedback: ->
    (applied delta float32, new residual, the gather's wire bytes: the
    int8 payload and a float32 scale a shard)."""
    applied, new_ef = delta.clone(), ef.clone()
    for a, e in zip(applied.view(n_shards, -1), new_ef.view(n_shards, -1)):
        _compress_in_place([(a, e)])
    return applied, new_ef, applied.numel() + 4 * n_shards


def _compress_in_place(pairs) -> None:
    """One shard's int8 quantization with error feedback over its (delta,
    ef) segments, a chunk at a time (the reference's ``quantize_int8`` /
    ``dequantize_int8`` op for op, one scale for the shard): each delta
    segment becomes the applied delta, each ef segment the new residual."""
    pairs = [(d, e) for d, e in pairs if d.numel()]
    for d, e in pairs:
        d.add_(e)                                    # x = delta + ef
    top = torch.stack([d[c:c + CHUNK].abs().amax() for d, _ in pairs
                       for c in range(0, d.numel(), CHUNK)]).amax()
    scale = top / torch.tensor(127.0, device=top.device)
    scale = torch.where(scale > 0.0, scale, 1.0)
    for d, e in pairs:
        for c in range(0, d.numel(), CHUNK):
            x = d[c:c + CHUNK]
            applied = torch.round(x / scale).to(torch.int8).float() * scale
            e[c:c + CHUNK] = x - applied
            x.copy_(applied)


def _segments(spec: FlatSpec, lo: int, hi: int):
    """(leaf index, flat start of the leaf, first, last) of every leaf's
    overlap with the flat range [lo, hi)."""
    off = 0
    for i, sz in enumerate(spec.sizes):
        a, b = max(off, lo), min(off + sz, hi)
        if a < b:
            yield i, off, a, b
        off += sz


@torch.no_grad()
def zero1_update(cfg: OptConfig, params, grads, state, spec: FlatSpec,
                 mesh=None, compress_collective: bool = False, pspecs=None):
    """Flat-space AdamW on the rank's slice; the delta gathered and
    subtracted from the params in place.  -> (params, state, {"gnorm",
    "lr", "collective_bytes"}).  Over a mesh ``params`` are the rank's
    blocks under ``pspecs`` and ``grads`` the full gradients, the same on
    every rank.  ``grads`` is a tree, or the list of its leaves, which the
    update then empties and lets go of leaf by leaf as it reads them (so
    that a full-width step never holds the float32 gradients and the whole
    delta at once).  ``compress_collective`` needs ``state["ef"]``; m, v and
    ef are updated in place."""
    n = _n_shards(mesh)
    lo, size = _local_range(spec, mesh)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    leaves = grads if isinstance(grads, list) else tree_leaves(grads)
    gl, gnorm = clip_by_global_norm(leaves, cfg.grad_clip)
    if isinstance(grads, list):
        grads.clear()
    del leaves
    bc1, bc2 = bias_corrections(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    m, v = state["m"], state["v"]
    pl = tree_leaves(params)
    specs = spec_leaves(pspecs) if mesh is not None else [()] * len(pl)
    near = dict((i, (off, a, b)) for i, off, a, b in _segments(spec, lo, lo + size))
    parts = []          # the rank's slice of the delta: (flat start, float32 segment)
    for i in range(len(pl)):
        # every rank takes part in every leaf's gather
        p = gather(pl[i], specs[i], mesh) if any(specs[i]) else pl[i]
        g, gl[i] = gl[i], None
        if i not in near:
            continue
        off, a, b = near[i]
        g, pf = g.reshape(-1), p.reshape(-1)
        d = torch.empty((b - a,), dtype=torch.float32, device=m.device)
        for c in range(a, b, CHUNK):
            e = min(c + CHUNK, b)
            gs = g[c - off:e - off]
            ms, vs = m[c - lo:e - lo], v[c - lo:e - lo]
            ms.mul_(b1).add_(gs * (1 - b1))
            vs.mul_(b2).add_(gs * (1 - b2) * gs)
            u = (ms / bc1) / (sqrt(vs / bc2) + cfg.eps) \
                + cfg.weight_decay * pf[c - off:e - off].float()
            d[c - a:e - a] = lr * u
        parts.append((a, d))
        del g, p, pf
    end = max(sum(spec.sizes), lo)        # the padding's delta is 0
    if end < lo + size:
        parts.append((end, torch.zeros((lo + size - end,), dtype=torch.float32,
                                       device=m.device)))
    new_state = {"m": m, "v": v, "step": step}
    if compress_collective:
        ef = state["ef"]
        _compress_in_place([(d, ef[a - lo:a - lo + d.numel()]) for a, d in parts])
        new_state["ef"] = ef
        wire = spec.padded + 4 * n
    else:
        if "ef" in state:        # threads through when the mode is toggled off
            new_state["ef"] = state["ef"]
        wire = 4 * spec.padded
    _apply_delta(pl, specs, spec, parts, lo, size, mesh)
    return params, new_state, {"gnorm": gnorm, "lr": lr, "collective_bytes": wire}


def _piece(parts, lo: int, c: int, e: int) -> torch.Tensor:
    """The slice's delta over flat [lo + c, lo + e), from its segments (a
    view when one segment holds it)."""
    out = []
    for a, d in parts:
        x, y = max(a, lo + c), min(a + d.numel(), lo + e)
        if x < y:
            out.append(d[x - a:y - a])
    return out[0] if len(out) == 1 else torch.cat(out)


def _apply_delta(pl, specs, spec: FlatSpec, parts, lo: int, size: int, mesh) -> None:
    """Gather every rank's slice of the float32 delta (all-gathers of
    ``CHUNK // n``-element pieces) and subtract each leaf's part from the
    rank's block, ``p = (p.float() - d).to(p.dtype)``: in place on a leaf
    held whole, through a full float32 buffer of the leaf otherwise."""
    n = _n_shards(mesh)
    group = mesh.group(mesh.axis_names) if mesh is not None else None
    pending = {}                 # split leaf -> [full delta, elements still due]
    step = max(CHUNK // n, 1)
    for c in range(0, size, step):
        piece = _piece(parts, lo, c, min(c + step, size))
        got = ([(piece, c)] if mesh is None else
               list(zip(col.all_gather(piece, 0, group).chunk(n),
                        (r * size + c for r in range(n)))))
        for vals, at in got:
            for i, off, a, b in _segments(spec, at, at + vals.numel()):
                d = vals[a - at:b - at]
                p = pl[i]
                if tuple(p.shape) == spec.shapes[i]:
                    seg = p.view(-1)[a - off:b - off]
                    seg.copy_(seg.float() - d)
                    continue
                buf = pending.setdefault(i, [torch.empty(spec.sizes[i], dtype=torch.float32,
                                                         device=p.device), spec.sizes[i]])
                buf[0][a - off:b - off] = d
                buf[1] -= b - a
                if buf[1] == 0:
                    local = shard(buf[0].view(spec.shapes[i]), specs[i], mesh)
                    p.copy_(p.float() - local)
                    del pending[i]
