"""ZeRO-1 on one device: the optimizer state as flat float32 vectors (port
of ``repro/optim/zero1.py`` at ``n_shards = 1``).

Adam's m and v are elementwise, so they need no tensor structure: every
param is flattened into one padded 1-D vector, in JAX's flatten order of
the params tree (dict keys sorted, :func:`repro_torch.ckpt.manager.tree_leaves`),
so that the flat layout, and a checkpoint of it, is the reference's.  The
update runs in flat space and its delta is unflattened back onto the
leaves.

``compress_collective`` (DESIGN.md §14) quantizes the flat delta to int8,
one symmetric scale per shard, before the gather back to the params; a
float32 error-feedback vector ``state["ef"]`` carries the quantization
residual into the next step.  The global-norm clip runs on the gradient
tree before flattening, and the quantization strictly after the flat-space
optimizer math, so m, v and step are bitwise those of the uncompressed
update; only the applied delta differs.  Without a mesh the offload of the
master vectors to the host tier (``offload_opt`` / ``fetch_opt``) is the
identity, as the reference's.  The delta's int8 scale divides as
:mod:`repro_torch.dist.compression`'s does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.optim.optimizers import (OptConfig, bias_corrections,
                                          clip_by_global_norm, schedule, sqrt)
from repro_torch.tiering.codec import dequantize_int8, quantize_int8


@dataclasses.dataclass
class FlatSpec:
    sizes: list
    shapes: list
    like: object        # the params tree's structure (0 for every leaf)
    padded: int


def _n_shards(mesh) -> int:
    if mesh is not None:
        raise NotImplementedError(
            "ZeRO-1 over a mesh is not yet ported to repro_torch (ROADMAP "
            "item 10, the distribution layer)")
    return 1


def flat_spec(params, n_shards: int = 1) -> FlatSpec:
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
    """-> (state {"m", "v", "step"[, "ef"]}, FlatSpec)."""
    spec = flat_spec(params, _n_shards(mesh))
    dev = tree_leaves(params)[0].device
    z = lambda: torch.zeros((spec.padded,), dtype=torch.float32, device=dev)
    state = {"m": z(), "v": z(),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if compress_collective:
        state["ef"] = z()
    if offload:
        state = offload_opt(state, mesh)
    return state, spec


def offload_opt(state, mesh=None):
    """Demote the master vectors to the slow tier: the identity on one
    device."""
    _n_shards(mesh)
    return state


def fetch_opt(state, mesh=None):
    """Promote the master vectors back: the identity on one device."""
    _n_shards(mesh)
    return state


def compress_delta(delta: torch.Tensor, ef: torch.Tensor, n_shards: int = 1):
    """int8-quantize the flat delta per shard with error feedback: ->
    (applied delta float32, new residual, the gather's wire bytes: the
    int8 payload and a float32 scale a shard)."""
    x = delta + ef
    q, scale = quantize_int8(x.reshape(n_shards, -1), axes=(1,))
    applied = dequantize_int8(q, scale, torch.float32).reshape(-1)
    return applied, x - applied, q.numel() + 4 * n_shards


@torch.no_grad()
def zero1_update(cfg: OptConfig, params, grads, state, spec: FlatSpec,
                 mesh=None, compress_collective: bool = False):
    """Flat-space AdamW; the delta unflattened back onto the params, which
    are written in place.  -> (params, state, {"gnorm", "lr",
    "collective_bytes"}).  ``compress_collective`` needs ``state["ef"]``."""
    n = _n_shards(mesh)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gl, gnorm = clip_by_global_norm(tree_leaves(grads), cfg.grad_clip)
    g = torch.nn.functional.pad(torch.cat([x.reshape(-1) for x in gl]),
                                (0, spec.padded - sum(spec.sizes)))
    del gl
    b1, b2 = cfg.b1, cfg.b2
    m = b1 * state["m"] + (1 - b1) * g
    v = b2 * state["v"] + (1 - b2) * g * g
    del g
    bc1, bc2 = bias_corrections(cfg, step)
    u = (m / bc1) / (sqrt(v / bc2) + cfg.eps) \
        + cfg.weight_decay * flatten(params, spec)
    delta = lr * u
    del u
    new_state = {"m": m, "v": v, "step": step}
    if compress_collective:
        delta, new_state["ef"], wire = compress_delta(delta, state["ef"], n)
    else:
        if "ef" in state:        # threads through when the mode is toggled off
            new_state["ef"] = state["ef"]
        wire = 4 * spec.padded
    # the delta stays float32 to the subtraction, which casts once a leaf
    off = 0
    for p, sz in zip(tree_leaves(params), spec.sizes):
        p.copy_(p.float() - delta[off:off + sz].reshape(p.shape))
        off += sz
    return params, new_state, {"gnorm": gnorm, "lr": lr, "collective_bytes": wire}
