"""Placement rules for params, caches and batches, and the blocks a rank
holds (port of ``repro/dist/sharding.py``).

A spec is a tuple with one entry per dim: ``None`` (not split), an axis
name, or a tuple of axis names (split over their ranks, the first axis
major) — ``jax.sharding.PartitionSpec``'s layout.  Every tensor is placed
from its *name* (the role it plays) and its *shape* (what divides), by the
Megatron conventions the models are written against:

  * MoE expert stacks (E, D, F)      -> the expert dim over 'model' (EP)
  * column weights (D, F), qkv proj  -> the output dim over 'model'
  * row weights (F, D), out proj     -> the contracted dim over 'model'
  * the embedding table (V, D)       -> the vocab over 'model'
  * norms, biases, routers, scalars  -> replicated

A dim that does not divide stays whole, so a spec made here is valid on any
mesh.  Only ``.shape`` is read, so the meshes may be
:class:`repro_torch.launch.mesh.MeshShape` stand-ins and the leaves
meta-device tensors.

:func:`shard` and :func:`gather` stand for the reference's
``device_put(NamedSharding)``: a rank's block of a full tensor, and the
full tensor from the blocks.  :class:`Layout` gathers a pattern group's
stored blocks before the group runs (one autograd function a call, with
:mod:`repro_torch.dist.collectives`' backward rules), where XLA's
partitioner would have placed the collectives.  Compute is data-parallel
over the data axes.  Over 'model' the leaves of the subtrees a layout
names in ``split`` compute split (every arch): the attention weights
(self and cross attention's and the encoder's GQA ``wq``/``wk``/``wv``,
MLA's ``wq_a``/``wq_b``/``wkv_a``/``wkv_b`` column-parallel, ``wo``
row-parallel), the MLPs and a MoE block's shared expert (``w_gate``/
``w_in``, ``sh_gate``/``sh_in`` column-parallel, ``w_out``/``sh_out``
row-parallel), the MTP head's projection (column-parallel), the recurrent
mixers (Mamba2's ``in_proj``/``conv_w``, gathered whole in the mixer, and
``out_proj``; mLSTM's ``wq``/``wk``/``wv``/``ogate`` and ``wo``; sLSTM's
``wz``/``wi``/``wf``/``wo_gate`` and ``wo``) and the embedding table
(vocab-parallel embedding and head), each gathered over the data axes
alone so that the rank computes with its 'model' block
(``models/layers.py``, ``models/attention.py``, ``models/moe.py``,
``models/mamba2.py``, ``models/xlstm.py``).  Every other leaf is
gathered whole and computes replicated over 'model', but the MoE expert
stacks, which stay split for the expert-parallel body.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as col
from repro_torch.launch.mesh import DP_AXES, axis_size

# trailing param names -> sharding role
_ROW = ("wo", "w_out", "sh_out", "out_proj")              # (F, D): shard F
_REPLICATED = ("router", "router_bias", "residency", "fetch_ids", "xgate")


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn("blocks/0/ffn/w_in", leaf)`` over a tree of dicts, lists and
    NamedTuples (the reference's ``path_str`` of every leaf, a NamedTuple's
    fields by name); a plain tuple is a leaf, so spec trees map too."""
    sub = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, sub(i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map_with_path(fn, getattr(tree, f), sub(f))
                            for f in tree._fields])
    return fn(path, tree)


def _dp(mesh) -> tuple:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def _entry(axes: tuple):
    """A spec entry for ``axes``: one axis by its name (as
    ``PartitionSpec`` normalises a 1-tuple), several as a tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _fits(size: int, mesh, axes) -> bool:
    n = axis_size(mesh, axes)
    return n >= 1 and size >= n and size % n == 0


def param_pspecs(params, mesh, *, fsdp: bool = False):
    """A spec for every leaf of a params tree (same structure).

    ``fsdp`` additionally splits one remaining dim of each weight of two or
    more dims over the data axes (ZeRO-3 storage; compute gathers it a
    group at a time)."""
    model = "model" if "model" in mesh.axis_names else None
    dp = _dp(mesh)

    def infer(p, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        name = p.rsplit("/", 1)[-1]
        # params["blocks"] leaves are stacked over layer groups: the leading
        # G dim is looped over, never split
        lead = 1 if p.startswith("blocks") else 0
        dims = [None] * nd
        if name in _REPLICATED or nd - lead < 2:
            return tuple(dims)
        if nd - lead == 3 and name.startswith(("w_", "fetch_")):
            tp = lead                # MoE expert stack (E, D, F): EP over E
        elif name in _ROW:
            tp = lead                # (F, D): row-parallel
        elif name == "table":
            tp = lead                # (V, D): the vocab
        else:
            tp = nd - 1              # column-parallel
        if model is not None and _fits(shape[tp], mesh, model):
            dims[tp] = model
        if fsdp and dp:
            for axes in ((dp,) if len(dp) == 1 else (dp, dp[-1:])):
                hit = next((i for i in range(lead, nd)
                            if dims[i] is None and _fits(shape[i], mesh, axes)),
                           None)
                if hit is not None:
                    dims[hit] = _entry(axes)
                    break
        return tuple(dims)

    return tree_map_with_path(infer, params)


def batch_pspec(mesh) -> tuple:
    """(B, S) token batches: rows over the data-parallel axes."""
    dp = _dp(mesh)
    return (_entry(dp) if dp else None, None)


def cache_pspecs(cache, mesh, *, slot_axes: tuple | None = None):
    """A spec for every leaf of a KV cache (full-sequence or paged).

    Full caches: the batch dim over the data axes, the k/v sequence dim over
    'model'.  With ``slot_axes`` (paged caches): the page slots split over
    those axes, everything else replicated."""
    if slot_axes is not None:
        n_shards = axis_size(mesh, tuple(slot_axes))

        def leaf_paged(p, l):
            nd = len(l.shape)
            if nd == 0:
                return ()
            lead = 1 if "blocks" in p else 0
            dims = [None] * nd
            if any(s in p for s in ("k_pages", "v_pages", "page_len")) \
                    and nd > lead + 1 and l.shape[lead + 1] % n_shards == 0:
                dims[lead + 1] = _entry(tuple(slot_axes))
            return tuple(dims)

        return tree_map_with_path(leaf_paged, cache)

    dp = _dp(mesh)
    dp_size = axis_size(mesh, dp)
    m = "model" if "model" in mesh.axis_names else None

    def leaf_full(p, l):
        nd = len(l.shape)
        if nd == 0:
            return ()
        lead = 1 if "blocks" in p else 0
        dims = [None] * nd
        if dp and nd > lead and l.shape[lead] % max(dp_size, 1) == 0 \
                and l.shape[lead] >= dp_size:
            dims[lead] = _entry(dp)
        # the sequence dim of k/v caches: (lead, B, S, ...) -> lead + 1
        if any(p.endswith(suf) for suf in ("/k", "/v", "c_kv", "k_rope")) \
                and nd > lead + 1 and m \
                and l.shape[lead + 1] % mesh.shape["model"] == 0:
            dims[lead + 1] = m
        return tuple(dims)

    return tree_map_with_path(leaf_full, cache)


def entry_axes(entry) -> tuple:
    """The axes a spec entry splits over (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split_dims(spec):
    """(dim, axes tuple) of every split dim of a spec."""
    return [(d, entry_axes(a)) for d, a in enumerate(spec) if a is not None]


def shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's block of ``full`` under ``spec`` (a view of ``full``
    where nothing is split)."""
    x = full
    for d, axes in _split_dims(spec):
        x = x.chunk(mesh.axis_size(axes), d)[mesh.coord(axes)]
    return x.contiguous()


def gather(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec`` (all-gathers,
    no gradient)."""
    return gather_many([local], [spec], mesh)[0]


def gather_many(leaves, specs, mesh) -> list:
    """:func:`gather` of many blocks, bucketed (one all-gather a bucket of
    blocks split over the same axes)."""
    return _gather_rounds(list(leaves), [tuple((d, mesh.group(a)) for d, a in
                                               _split_dims(s)) for s in specs])


def _gather_rounds(leaves: list, plans) -> list:
    """Each leaf gathered along its plan's (dim, group) steps: the k-th
    steps of all leaves in one bucketed round."""
    leaves = list(leaves)
    for k in range(max((len(p) for p in plans), default=0)):
        idx = [i for i, p in enumerate(plans) if len(p) > k]
        got = col.all_gather_many([(leaves[i], plans[i][k][0], plans[i][k][1])
                                   for i in idx])
        for i, x in zip(idx, got):
            leaves[i] = x
    return leaves


def drop_axes(spec, axes) -> tuple:
    """``spec`` with ``axes`` taken out of every entry."""
    out = []
    for a in spec:
        rest = tuple(x for x in ((a,) if isinstance(a, str) else (a or ()))
                     if x not in axes)
        out.append(None if not rest else rest[0] if isinstance(a, str) else rest)
    return tuple(out)


class _GatherTree(torch.autograd.Function):
    """All-gathers of many leaves in one autograd node (bucketed rounds)."""

    @staticmethod
    def forward(ctx, plans, *leaves):
        ctx.plans = plans
        return tuple(_gather_rounds(list(leaves), [[(d, g) for d, g, _ in p]
                                                   for p in plans]))

    @staticmethod
    def backward(ctx, *grads):
        out, plans = list(grads), ctx.plans
        for k in reversed(range(max((len(p) for p in plans), default=0))):
            idx = [i for i, p in enumerate(plans) if len(p) > k]
            red = [i for i in idx if plans[i][k][2]]
            for i in idx:
                if not plans[i][k][2]:
                    d, group, _ = plans[i][k]
                    out[i] = col.block(out[i], d, group).contiguous()
            got = col.reduce_scatter_many([(out[i], plans[i][k][0], plans[i][k][1])
                                           for i in red])
            for i, g in zip(red, got):
                out[i] = g
        return (None,) + tuple(out)


class Layout:
    """How a rank's stored blocks become the weights a group computes
    with: ``specs`` (a tree like the params) names each leaf's split dims
    left to gather; a dim split over the data axes reduce-scatters its
    gradient, one split over 'model' takes its block
    (:mod:`repro_torch.dist.collectives`).  ``split`` names the subtrees
    ("embed", "blocks/0/attn", ...) whose specs keep no 'model' split, so
    that they compute their share: :meth:`part_of` gives those the
    rank's :class:`repro_torch.dist.collectives.Part` of 'model'."""

    def __init__(self, mesh, specs, split=()):
        self.mesh, self.specs = mesh, specs
        self.split = frozenset(split)
        self.part = (col.Part(mesh.group("model"), mesh.coord("model"),
                              mesh.axis_size("model")) if self.split else None)

    def part_of(self, path: str):
        """The rank's Part where subtree ``path`` computes split, else None."""
        return self.part if path in self.split else None

    def parts(self, block: str) -> dict:
        """The attention, MLP, recurrent mixer and cross attention parts
        ("attn", "ffn", "mix", "xattn") of the block at path ``block``
        ("blocks/0", "prologue/1", "mtp/block", "shared_attn",
        "encoder/0")."""
        return {k: self.part_of(f"{block}/{k}") for k in ("attn", "ffn", "mix", "xattn")}

    def _plan(self, spec) -> tuple:
        plan = []
        for d, axes in _split_dims(spec):
            dp = [a in DP_AXES for a in axes]
            if any(dp) and not all(dp):
                raise ValueError(f"spec {spec}: a dim split over data and model axes")
            plan.append((d, self.mesh.group(axes), all(dp)))
        return tuple(plan)

    def gather(self, tree, specs):
        """``tree`` (a subtree of stored blocks) with every leaf gathered
        under ``specs`` (the matching subtree of specs)."""
        from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
        leaves = tree_leaves(tree)
        if not leaves:
            return tree
        plans = tuple(self._plan(s) for s in spec_leaves(specs))
        return tree_unflatten(tree, list(_GatherTree.apply(plans, *leaves)))


def spec_leaves(specs) -> list:
    """A spec tree's specs in :func:`repro_torch.ckpt.manager.tree_leaves`
    order (a spec is a tuple, not a node)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def per_group(specs):
    """The specs of one group of group-stacked blocks (the G dim dropped)."""
    return tree_map_with_path(lambda _, s: tuple(s[1:]), specs)
