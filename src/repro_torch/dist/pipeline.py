"""GPipe microbatch pipeline over one mesh axis (port of
``repro/dist/pipeline.py``).

Stage i's weights live on the rank at coordinate i of ``axis``;
microbatches enter at stage 0 and move stage to stage around a ring of
point-to-point sends (``batch_isend_irecv``, the reference's
``ppermute``), one hop a tick.  m microbatches through n stages take
m + n - 1 ticks, with the usual (n - 1) / (m + n - 1) bubble.  Every rank
runs :func:`pipeline_apply` on its own stage.

The pipeline is differentiable, as ``jax.grad`` differentiates the
reference's ``shard_map``: the ring shift's backward sends each gradient
the other way round the ring (i -> i - 1), the final sum over ``axis``
passes the replicated output gradient through
(:func:`repro_torch.dist.collectives.sum_parts`), and the replicated input
enters with an all-reduce backward (:func:`repro_torch.dist.collectives.enter`),
so every rank holds the input's whole gradient and its own stage's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import tree_map_with_path


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in ``group`` and receive
    the one from ``step`` places back."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    nxt = dist.get_global_rank(group, (r + step) % n)
    prv = dist.get_global_rank(group, (r - step) % n)
    col.record("collective-permute", out, group)
    ops = [dist.P2POp(dist.isend, x.contiguous(), nxt, group=group),
           dist.P2POp(dist.irecv, out, prv, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


def _ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` to the next rank of ``group`` and receive the previous
    rank's (the ppermute i -> i + 1 mod n); backward, i -> i - 1."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group)


def pipeline_apply(stage_fn, stage_params, x, *, mesh, axis: str):
    """Apply ``stage_fn(w_i, .)`` for i = 0..n-1 as a microbatch pipeline.

    stage_fn:     (stage weights, (mb, ...) activations) -> (mb, ...)
                  activations, shape- and dtype-preserving.
    stage_params: this rank's stage: a tree (dicts and lists) of tensors
                  with a leading dim of 1 (the rank's block of the
                  (n_stages, ...) stacks,
                  :func:`repro_torch.dist.sharding.shard` over ``axis``).
    x:            (n_micro, mb, ...) microbatched input, the same on every
                  rank.
    Returns stage_{n-1}(...stage_0(x)) per microbatch, (n_micro, mb, ...),
    on every rank (the last stage's outputs summed over ``axis``).
    """
    group = mesh.group(axis)
    n_stages = mesh.axis_size(axis)
    idx = mesh.coord(axis)
    w = tree_map_with_path(lambda _, v: v[0], stage_params)
    x = col.enter(x, group)
    feed = torch.cat([x, x.new_zeros((n_stages - 1,) + tuple(x.shape[1:]))])
    first = torch.tensor(idx == 0, device=x.device)
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(x.shape[0] + n_stages - 1):
        # stage 0 takes a fresh microbatch, the others what the ring
        # brought; both stay in the graph, so that every rank runs every
        # tick's shift backward
        out = stage_fn(w, torch.where(first, feed[t], buf))
        outs.append(out)
        buf = _ring_shift(out, group)
    # microbatch j leaves the last stage at tick j + n_stages - 1
    y = torch.stack(outs[n_stages - 1:])
    last = torch.tensor(idx == n_stages - 1, device=x.device)
    return col.sum_parts(torch.where(last, y, torch.zeros_like(y)), group)
