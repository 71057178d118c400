"""GPipe microbatch pipeline over one mesh axis (port of
``repro/dist/pipeline.py``).

Stage i's weights live on the rank at coordinate i of ``axis``;
microbatches enter at stage 0 and move stage to stage around a ring of
point-to-point sends (``batch_isend_irecv``, the reference's
``ppermute``), one hop a tick.  m microbatches through n stages take
m + n - 1 ticks, with the usual (n - 1) / (m + n - 1) bubble.  Every rank
runs :func:`pipeline_apply` on its own stage.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import all_reduce


def _ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` to the next rank of ``group`` and receive the previous
    rank's (the ppermute i -> i + 1 mod n)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x
    out = torch.empty_like(x)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    ops = [dist.P2POp(dist.isend, x.contiguous(), nxt, group=group),
           dist.P2POp(dist.irecv, out, prv, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


@torch.no_grad()
def pipeline_apply(stage_fn, stage_params, x, *, mesh, axis: str):
    """Apply ``stage_fn(w_i, .)`` for i = 0..n-1 as a microbatch pipeline.

    stage_fn:     (stage weights, (mb, ...) activations) -> (mb, ...)
                  activations, shape- and dtype-preserving.
    stage_params: this rank's stage: a dict of tensors with a leading dim
                  of 1 (the rank's block of the (n_stages, ...) stacks,
                  :func:`repro_torch.dist.sharding.shard` over ``axis``).
    x:            (n_micro, mb, ...) microbatched input, the same on every
                  rank.
    Returns stage_{n-1}(...stage_0(x)) per microbatch, (n_micro, mb, ...),
    on every rank (the last stage's outputs summed over ``axis``).
    """
    group = mesh.group(axis)
    n_stages = mesh.axis_size(axis)
    idx = mesh.coord(axis)
    w = {k: v[0] for k, v in stage_params.items()}
    feed = torch.cat([x, x.new_zeros((n_stages - 1,) + tuple(x.shape[1:]))])
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(x.shape[0] + n_stages - 1):
        # stage 0 takes a fresh microbatch; the others what the ring brought
        out = stage_fn(w, feed[t] if idx == 0 else buf)
        outs.append(out)
        buf = _ring_shift(out, group)
    # microbatch j leaves the last stage at tick j + n_stages - 1
    y = torch.stack(outs[n_stages - 1:])
    if idx != n_stages - 1:
        y = torch.zeros_like(y)
    return all_reduce(y, group)
