"""Collectives over a process group, and the autograd rules of the
per-rank code that stands in for the reference's ``shard_map`` bodies and
for the partitioner's collectives.

Compute over a mesh is data-parallel over the data axes.  Over ``'model'``
every rank of a group sees the same tokens and computes the same loss; in
between, a region's ranks each compute a share of it (the tensor-parallel
layers of the dense decoders and the MoE family, the expert-parallel MoE
body: a :class:`Part`).  A gradient therefore flows across a collective by what
the ranks on its other side computed:

  * :func:`gather` (an all-gather forward) returns, backward, the rank's
    block of the gradient: summed over the group (a reduce-scatter) where
    the ranks computed different things with the whole (``reduce=True``:
    the data axes, a partitioned attention core's keys and values), taken
    as it is (a slice) where they computed the same gradient;
  * :func:`enter` marks a replicated tensor entering a region whose ranks
    each compute a part of the result (a column-parallel matmul's input,
    the expert-parallel MoE body): identity forward, a sum of the parts'
    input gradients (an all-reduce) backward;
  * :func:`sum_parts` leaves that region: the parts summed (an all-reduce)
    forward, the replicated gradient passed through (identity) backward;
  * :func:`psum` sums parts that each rank goes on computing its own share
    from (a norm's sum of squares over a split width, a contraction over a
    split head dim): an all-reduce forward and backward;
  * :func:`exchange` (an all-to-all) trades a split over one dim for a
    split over another, backward the inverse all-to-all;
  * :func:`max_over` is a MAX all-reduce without a gradient (the
    vocab-parallel loss's shift).

``torch.distributed.nn.functional.all_reduce`` differs: its backward is an
all-reduce, which counts a replicated gradient once per rank.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def group_size(group) -> int:
    return dist.get_world_size(group)


@dataclasses.dataclass(frozen=True)
class Part:
    """A rank's share of a partitioned computation: the 'model' group, the
    rank's coordinate in it and its size; the rank holds block ``rank`` of
    ``size`` along every split dim."""
    group: object
    rank: int
    size: int

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's block of ``x`` along ``dim`` (a view)."""
        return x.chunk(self.size, dim)[self.rank]

    def sub(self, k: int) -> "Part":
        """The Part of the ``k`` consecutive ranks this rank's block of
        ``k`` holds (ranks ``k * (rank // k)`` on), over a process group
        made once, by its member ranks alone."""
        if k == self.size:
            return self
        lo = self.rank // k * k
        made = _SUBGROUPS.get((id(self.group), lo))
        if made is None or made[0] is not self.group:
            ranks = dist.get_process_group_ranks(self.group)[lo:lo + k]
            made = (self.group, dist.new_group(ranks, use_local_synchronization=True))
            _SUBGROUPS[(id(self.group), lo)] = made
        return Part(made[1], self.rank - lo, k)


# (id of a group, first rank) -> (the group, the subgroup made from it); the
# group is held, so that its id is not reused while the entry stands
_SUBGROUPS = {}


# () -> the census counting this thread's ops, or None; set by
# repro_torch.roofline.census while a census runs, None otherwise
census_hook = None


def record(op: str, result: torch.Tensor, group) -> None:
    """Report one collective to an active census (``census_hook``): its
    result's bytes, nothing over a group of one rank."""
    c = census_hook() if census_hook is not None else None
    n = group_size(group) if c is not None else 1
    if n > 1:
        c.record(op, result.numel() * result.element_size(), n)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order."""
    n = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    record("all-gather", out, group)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's block along ``dim`` of the group's sum of ``x``."""
    n = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    record("reduce-scatter", out, group)
    _reduce_scatter(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's block of ``x`` along ``dim`` (no communication)."""
    n = group_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)]


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the group, in place (through a contiguous copy
    where ``x`` is a strided view: NCCL takes contiguous buffers only);
    returns ``x``."""
    y = x if x.is_contiguous() else x.contiguous()
    record("all-reduce", y, group)
    dist.all_reduce(y, op=op, group=group)
    if y is not x:
        x.copy_(y)
    return x


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """``x`` cut into the group's number of blocks along ``split_dim``,
    block j sent to rank j, and the blocks received concatenated along
    ``cat_dim`` in group rank order."""
    n = group_size(group)
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    record("all-to-all", recv, group)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat_dim)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group (a new tensor, no
    gradient)."""
    return all_reduce(x.detach().clone(), group, op=dist.ReduceOp.MAX)


BUCKET_BYTES = 1 << 28    # a bucketed collective's buffer, at most


def _buckets(items, key, nbytes):
    """``items`` in their order, grouped by ``key(item)`` and cut so that
    each bucket's ``nbytes`` stay within BUCKET_BYTES."""
    open_, out = {}, []
    for it in items:
        k = key(it)
        b = open_.get(k)
        if b is None or (b[1] and b[1] + nbytes(it) > BUCKET_BYTES):
            b = open_[k] = [[], 0]
            out.append(b)
        b[0].append(it)
        b[1] += nbytes(it)
    return [b[0] for b in out]


def _key(x, group):
    return (id(group), x.dtype, x.device)


def all_gather_many(items) -> list:
    """:func:`all_gather` of many ``(x, dim, group)``, one collective a
    bucket of tensors that share a group, dtype and device."""
    out = [None] * len(items)
    for bucket in _buckets(list(enumerate(items)), lambda it: _key(it[1][0], it[1][2]),
                           lambda it: it[1][0].numel() * it[1][0].element_size()):
        group = bucket[0][1][2]
        n = group_size(group)
        moved = [x.movedim(d, 0).contiguous() for _, (x, d, _) in bucket]
        flat = torch.cat([m.reshape(-1) for m in moved])
        whole = torch.empty((n * flat.numel(),), dtype=flat.dtype, device=flat.device)
        record("all-gather", whole, group)
        dist.all_gather_into_tensor(whole, flat, group=group)
        whole = whole.view(n, -1)
        off = 0
        for (i, (_, d, _)), m in zip(bucket, moved):
            part = whole[:, off:off + m.numel()].reshape((n * m.shape[0],) + tuple(m.shape[1:]))
            out[i] = part.movedim(0, d).contiguous()
            off += m.numel()
    return out


def reduce_scatter_many(items) -> list:
    """:func:`reduce_scatter` of many ``(x, dim, group)``, bucketed as
    :func:`all_gather_many`."""
    out = [None] * len(items)
    for bucket in _buckets(list(enumerate(items)), lambda it: _key(it[1][0], it[1][2]),
                           lambda it: it[1][0].numel() * it[1][0].element_size()):
        group = bucket[0][1][2]
        n = group_size(group)
        moved = [x.movedim(d, 0).contiguous() for _, (x, d, _) in bucket]
        rows = [m.reshape(n, -1) for m in moved]           # rank r's block: row r
        flat = torch.cat(rows, dim=1).reshape(-1)
        mine = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
        record("reduce-scatter", mine, group)
        _reduce_scatter(mine, flat, group=group)
        off = 0
        for (i, (_, d, _)), m, r in zip(bucket, moved, rows):
            part = mine[off:off + r.shape[1]].reshape((m.shape[0] // n,) + tuple(m.shape[1:]))
            out[i] = part.movedim(0, d).contiguous()
            off += r.shape[1]
    return out


def all_reduce_many(tensors, group) -> None:
    """:func:`all_reduce` of many tensors in place, one collective a bucket
    (tensors that share a dtype and device)."""
    for bucket in _buckets(list(tensors), lambda x: _key(x, group),
                           lambda x: x.numel() * x.element_size()):
        flat = torch.cat([x.reshape(-1) for x in bucket])
        record("all-reduce", flat, group)
        dist.all_reduce(flat, group=group)
        off = 0
        for x in bucket:
            x.copy_(flat[off:off + x.numel()].view(x.shape))
            off += x.numel()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return block(g, ctx.dim, ctx.group).contiguous(), None, None, None


def gather(x: torch.Tensor, dim: int, group, *, reduce: bool) -> torch.Tensor:
    """All-gather along ``dim``; backward, the block of the gradient summed
    over the group (``reduce``) or as it is (see the module docstring)."""
    return _Gather.apply(x, dim, group, reduce)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the group's input gradients summed backward."""
    return _Enter.apply(x, group)


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_parts(x: torch.Tensor, group) -> torch.Tensor:
    """The group's parts summed forward; the gradient passed through."""
    return _SumParts.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's parts summed forward, and the gradient's parts summed
    backward (each rank's gradient of the sum is its own share's)."""
    return _Psum.apply(x, group)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return all_to_all(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return all_to_all(g, cat_dim, split_dim, ctx.group), None, None, None


def exchange(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """:func:`all_to_all` forward: a tensor split over the group along
    ``cat_dim`` becomes one split along ``split_dim``; backward the inverse
    all-to-all."""
    return _Exchange.apply(x, split_dim, cat_dim, group)
