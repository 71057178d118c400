"""Optimizers: AdamW and Adafactor over trees of tensors (port of
``repro/optim/optimizers.py``).

Both are (init, update) pairs over the params tree (nested dicts and lists
of tensors); ZeRO-1's flat form is :mod:`repro_torch.optim.zero1`.  The
update is the reference's arithmetic, op for op in float32: the global-norm
clip over the leaves in JAX's flatten order (dict keys sorted), no master
weights (every update is ``(p.float() - lr * u).to(p.dtype)``), ``step`` an
int32 that counts from 1 and the bias corrections ``b ** step`` in float32.
Adafactor keeps a factored second moment (row and column means) for every
leaf whose last two dims exceed 1, and clips its update to RMS 1.

Over a mesh (:mod:`repro_torch.train.step`) the params are the rank's
blocks: ``block(i, x)`` takes leaf i's block of a gradient, which AdamW
applies to the clipped gradient (its m and v are blocks too) and Adafactor
to the clipped gradient or, from whole gradients, to the update.  The
gradients may be the rank's blocks themselves (their squares summed over
the ranks for the norm, ``norm``); Adafactor then sums its row and column
means, ``vr``'s mean and the update's RMS over the ranks that split the
dims they reduce (``groups``).  Adafactor's moments rest as blocks too
(``vr`` under the param's spec without its last dim, ``vc`` without its
second last); from whole gradients ``moments = (whole, blocks)`` gathers
every leaf's moments before the update and takes the blocks of the new
ones.

The update writes the params and the moments in place and returns them, so
that a step at full width holds one copy of each: a caller that needs the
old values keeps a clone.  Products and sums are separate ops (no fused
multiply-add), each rounded as the reference rounds it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.dist import collectives as col


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine from ``lr`` down to 0.1 ``lr``; ``step``
    a () int32 tensor, the result () float32.  Divisors are tensors on the
    step's device (a CPU scalar divisor is a reciprocal product on CUDA)."""
    dev = step.device
    warm = torch.clamp_max(step / _f32(max(cfg.warmup_steps, 1), dev), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  CUDA's is; torch's vectorized
    CPU kernel misses by an ulp on ~0.6% of inputs, so on the CPU it is
    taken in float64, whose rounding to float32 is exact."""
    if x.device.type == "cpu":
        return x.double().sqrt().to(x.dtype)
    return torch.sqrt(x)


def global_norm(leaves, reduce=None) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of each leaf's float32 sum of
    squares; ``reduce(squares)``, where given, first sums each leaf's over
    the ranks that hold its other blocks, in place."""
    sqs = [leaf.float().square().sum() for leaf in leaves]
    if reduce is not None:
        reduce(sqs)
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return sqrt(total)


def clip_by_global_norm(leaves, max_norm: float, reduce=None):
    """-> (the leaves in float32 scaled by min(1, max_norm / max(norm,
    1e-9)), the norm).  Float32 leaves are scaled in place."""
    g = global_norm(leaves, reduce)
    # a Python number over a tensor is a reciprocal product in torch; the
    # reference divides
    scale = torch.clamp_max(_f32(max_norm, g.device) / torch.clamp_min(g, 1e-9),
                            1.0)
    out = []
    for leaf in leaves:
        if leaf.dtype == torch.float32:
            out.append(leaf.mul_(scale))
        else:
            out.append(leaf.float() * scale)
    return out, g


def _apply(p: torch.Tensor, lr: torch.Tensor, u: torch.Tensor) -> None:
    """``p = (p.float() - lr * u).to(p.dtype)`` in place."""
    p.copy_(p.float() - lr * u)


def bias_corrections(cfg: OptConfig, step: torch.Tensor):
    sf = step.float()
    return 1 - cfg.b1 ** sf, 1 - cfg.b2 ** sf


# -- AdamW ---------------------------------------------------------------------

def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    return {"m": tree_unflatten(params, [zeros(p) for p in leaves]),
            "v": tree_unflatten(params, [zeros(p) for p in leaves]),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def _whole(_, x):
    return x


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state, block=_whole, norm=None):
    """-> (params, state, {"gnorm", "lr"}); ``grads`` a tree like
    ``params`` (float32 gradients are clipped in place).  Over a mesh the
    gradients may be blocks: ``norm`` then sums their squares over the
    ranks (:func:`global_norm`'s ``reduce``)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gl, gnorm = clip_by_global_norm(tree_leaves(grads), cfg.grad_clip, norm)
    bc1, bc2 = bias_corrections(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    for i, (p, g, m, v) in enumerate(zip(tree_leaves(params), gl,
                                         tree_leaves(state["m"]),
                                         tree_leaves(state["v"]))):
        g = block(i, g)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        u = (m / bc1) / (sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        _apply(p, lr, u)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"gnorm": gnorm, "lr": lr}


# -- Adafactor (factored, momentum-free) ----------------------------------------

def factored(shape) -> bool:
    """Adafactor keeps a leaf of this shape as row and column means."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def st(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    leaves = tree_leaves(params)
    return {"s": tree_unflatten(params, [st(p) for p in leaves]),
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}


def _mean(x: torch.Tensor, dim, groups, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` (every dim where ``dim`` is None) of a block whose
    dims ``groups`` split (one process group or None per dim of ``x``):
    where a reduced dim is split, the block's sum summed over its ranks
    and divided by the whole count."""
    dims = tuple(range(x.dim())) if dim is None else (dim,)
    split = [groups[d] for d in dims if groups[d] is not None]
    if not split:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    total = x.sum(dim=dims, keepdim=keepdim)
    n = math.prod(x.shape[d] for d in dims)
    for group in split:
        col.all_reduce(total, group)
        n *= col.group_size(group)
    return total.div_(n)


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params, grads, state, block=_whole,
                     moments=None, norm=None, groups=None):
    """-> (params, state, {"gnorm", "lr"}).  Over a mesh, either the
    gradients are whole (``moments`` gathers the moments whole and
    ``block`` takes the update's block), or they are the live blocks
    (``norm`` as AdamW's) and ``groups(i)`` names, per dim of leaf i's
    block, the process group that splits it: ``block`` takes the leaf's
    block of its gradient and the row and column means, ``vr``'s mean and
    the update's RMS are summed over the ranks of the dims they reduce."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gl, gnorm = clip_by_global_norm(tree_leaves(grads), cfg.grad_clip, norm)
    decay = 1.0 - step.float() ** -0.8
    flat_p = tree_leaves(params)
    flat_s = _leaf_states(params, state["s"])
    if moments is not None:
        flat_s = moments[0](flat_s)
    new_s = []
    for i, (p, g, s) in enumerate(zip(flat_p, gl, flat_s)):
        gs = (None,) * p.dim()
        if groups is not None:
            g, gs = block(i, g), groups(i)
        g2 = g * g + 1e-30
        if "vr" in s:
            vr = decay * s["vr"] + (1 - decay) * _mean(g2, -1, gs)
            vc = decay * s["vc"] + (1 - decay) * _mean(g2, -2, gs)
            r = vr / torch.clamp_min(_mean(vr, -1, gs[:-1], keepdim=True), 1e-30)
            u = g / (sqrt(r)[..., None] * sqrt(vc)[..., None, :] + cfg.eps)
            new_s.append({"vr": vr, "vc": vc})
        else:
            v = decay * s["v"] + (1 - decay) * g2
            u = g / (sqrt(v) + cfg.eps)
            new_s.append({"v": v})
        del g2
        rms = sqrt(_mean(u * u, None, gs) + 1e-30)     # update clipping
        u = u / torch.clamp_min(rms, 1.0)
        if groups is None:
            u = block(i, u)
        u = u + cfg.weight_decay * p.float()
        _apply(p, lr, u)
    if moments is not None:
        new_s = moments[1](new_s)
    return params, {"s": tree_unflatten(params, new_s), "step": step}, \
        {"gnorm": gnorm, "lr": lr}


def _leaf_states(params, s_tree) -> list:
    """Adafactor's per-leaf state dicts in the params' leaf order."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _leaf_states(params[k], s_tree[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, s in zip(params, s_tree) for x in _leaf_states(p, s)]
    return [s_tree]


def make_optimizer(cfg: OptConfig):
    if cfg.kind == "adafactor":
        return adafactor_init, lambda p, g, s, block=_whole, moments=None, norm=None, \
            groups=None: adafactor_update(cfg, p, g, s, block, moments, norm, groups)
    return adamw_init, lambda p, g, s, block=_whole, moments=None, norm=None, \
        groups=None: adamw_update(cfg, p, g, s, block, norm)
