"""The train step, on one device or over a mesh (port of
``repro/train/step.py``).

``build_train_step(cfg, mesh=None, tcfg)`` returns ``train_step(state,
batch) -> (state, metrics)``, which

  1. splits the batch into ``microbatches`` strided microbatches (rows i,
     i + M, i + 2M, ..., the reference's layout-local split) and
     accumulates their bf16 gradients into float32 (autograd, one backward
     a microbatch, each pattern group under activation checkpointing when
     ``remat``);
  2. divides the sum by M and, for a MoE arch, feeds the router stream
     (M, G, n_moe, B/M, S, k), flattened and cut to its first 8,192 ids,
     to the in-step NeoProf sketch
     (:func:`repro_torch.core.neoprof.neoprof_observe`, whose update and
     mark launch the sketch kernels on the card);
  3. with ``grad_compression`` passes the gradients through the int8+EF
     link (:mod:`repro_torch.dist.compression`);
  4. updates with AdamW, Adafactor or flat ZeRO-1 (with
     ``compress_collective`` its int8+EF delta).

Over a mesh (:class:`repro_torch.launch.mesh.Mesh`) every rank runs the
step on its own tensors.  The params are stored as
:func:`repro_torch.dist.sharding.param_pspecs` places them (``fsdp`` adds a
data-axis split) and the batch rows are split over the data axes.  Each
pattern group gathers its weights before it runs
(:class:`repro_torch.dist.sharding.Layout`, from :func:`compute_layout`):
over the data axes only for the leaves that compute their share over
'model' — a dense decoder's, a MoE arch's or a recurrent arch's embedding
and head (vocab-parallel), its attention (GQA's q/k/v or MLA's projections
column-parallel, ``wo`` row-parallel, the core split by heads or by query
rows), its MLPs, a MoE arch's dense prologue, shared experts and MTP head
(Megatron's column and row parallelism), the recurrent mixers (Mamba2,
mLSTM by heads; sLSTM by channels) and zamba2's shared attention block,
as XLA's partitioner computes the reference's program — and
whole for every other leaf, which computes replicated over 'model', but the
MoE layers, which run expert-parallel (``_ep_context``).  The gradients
are summed over the data axes after every microbatch, or once after the
loop under ``local_grads`` (where the params enter the loop gathered over
the data axes, and ``grad_compression`` makes that sum
:func:`repro_torch.dist.compression.compress_psum`), then divided by M
times the data ranks, so that they equal the single-device gradients of
the whole batch.  AdamW and Adafactor update each rank's blocks from the
gradients' blocks as the loop left them (the norm's squares summed over
the ranks that hold a leaf's other blocks,
:meth:`_Placement.reduce_squares`; Adafactor's row and column means, its
``vr`` mean and its update's RMS over the ranks of the dims they reduce,
:meth:`_Placement.dim_groups`; its factored moments rest as blocks).  The
gradients are gathered whole first (``full_grads``) for the archs that
compute replicated over 'model' (Adafactor's moments then gathered whole
for the update) and where an option needs them whole: ZeRO-1, whose flat
slices cut across the leaves (the rank's vectors are its flat slices,
updated a segment at a time in place), and the int8+EF link of
``grad_compression``, whose ``ef`` is whole.
``offload_master`` keeps ZeRO-1's vectors in pinned host memory between
steps and fetches them on a side stream during the backward.

The state is ``{"params", "opt", "prof"[, "ef"]}``, the reference's tree
(:func:`init_state` builds and places it; :func:`make_state_shapes` builds
it on the meta device and :func:`state_specs` names where each leaf rests
over a mesh).  The step writes the params and optimizer moments in place
and returns the state.  Every tensor lives
on the state's device (or the master vectors on its host); nothing moves
to the host but the metrics the caller reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import sketch as sk
from repro_torch.core.neoprof import NeoProfParams, neoprof_init, neoprof_observe
from repro_torch.core.sketch import SketchParams
from repro_torch.dist import collectives as col
from repro_torch.dist import compression
from repro_torch.dist.sharding import (Layout, _entry, batch_pspec, drop_axes,
                                       entry_axes, gather_many, param_pspecs, shard,
                                       spec_leaves, tree_map_with_path)
from repro_torch.launch.mesh import DP_AXES, dp_axes
from repro_torch.models import transformer as tr
from repro_torch.models.moe import EPContext
from repro_torch.optim import zero1
from repro_torch.optim.optimizers import OptConfig, factored, make_optimizer

PROFILE_IDS = 8192      # router ids a step feeds the sketch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: bool = True
    grad_compression: bool = False
    zero1: bool = False
    compress_collective: bool = False  # int8+EF ZeRO-1 delta (DESIGN.md §14)
    fsdp: bool = False                 # ZeRO-3 weight storage over 'data'
    local_grads: bool = False          # one data-parallel reduce after the
                                       # microbatch loop (a mesh)
    offload_master: bool = False       # ZeRO-1 m/v/ef in pinned host memory
                                       # between steps (a mesh on the card)
    profile_experts: bool = True       # NeoMem router-stream profiling
    sketch_width: int = 1 << 14


def _ep_context(cfg: ArchConfig, mesh) -> EPContext | None:
    if cfg.moe is None or mesh is None:
        return None
    return EPContext(mesh=mesh, expert_axis="model", fsdp_axis="data",
                     dp_axes=dp_axes(mesh))


_EXPERT_LEAVES = ("w_gate", "w_in", "w_out", "fetch_gate", "fetch_in", "fetch_out")


def _expert_stack(path: str, spec) -> bool:
    """A MoE layer's (G, E, D, F) expert weights (the tiered arm's hot
    slots and fetch buffers too) and the fetch ids, which stay split over
    'model' for the expert-parallel body."""
    name = path.rsplit("/", 1)[-1]
    return path.startswith("blocks") and (
        (len(spec) == 4 and name in _EXPERT_LEAVES) or name == "fetch_ids")


def compute_layout(cfg: ArchConfig, mesh, specs) -> Layout:
    """What a group gathers before it runs, from the specs its leaves are
    held under: everything, but the 'model' split of the expert stacks
    under expert parallelism (a MoE arch) and of the leaves that compute
    their share (the embedding, self and cross attention, MLPs, shared
    experts, recurrent mixers and encoder blocks,
    :func:`repro_torch.models.transformer.model_split`)."""
    ep = cfg.moe is not None
    split = (tr.model_split(cfg, specs, mesh.axis_size("model"))
             if "model" in mesh.axis_names else set())

    def spec(p, s):
        if (ep and _expert_stack(p, s)) or _under(p, split):
            return drop_axes(s, ("model",))
        return s
    return Layout(mesh, tree_map_with_path(spec, specs), split)


def _under(path: str, subtrees) -> bool:
    """Whether leaf ``path`` is one of ``subtrees`` or inside one."""
    return any(path == k or path.startswith(f"{k}/") for k in subtrees)


def split_counts(layout: Layout, stored) -> tuple[int, int]:
    """(leaves computing their share over 'model', leaves gathered whole
    over 'model') of the params stored under ``stored`` (a spec tree):
    the leaves split over 'model' at rest, but the expert stacks, which
    stay split for the expert-parallel body."""
    kept = dict(_spec_items(layout.specs))
    n_split = n_gathered = 0
    for p, s in _spec_items(stored):
        if not _has_model(s) or _expert_stack(p, s):
            continue
        if _under(p, layout.split):
            n_split += 1
        elif _has_model(kept[p]):
            n_gathered += 1
    return n_split, n_gathered


def _has_model(spec) -> bool:
    return any("model" in entry_axes(e) for e in spec)


def _spec_items(specs) -> list:
    out = []
    tree_map_with_path(lambda p, s: out.append((p, s)), specs)
    return out


class _Placement:
    """Where a step's tensors live over ``mesh``: ``stored``, each param's
    spec at rest; ``live``, the blocks the microbatch loop takes gradients
    of (``stored``, or under ``local_grads`` gathered over the data axes);
    ``layout``, what each group gathers before it runs (``live``, but the
    expert stacks' 'model' split under expert parallelism)."""

    def __init__(self, cfg: ArchConfig, mesh, tcfg: "TrainConfig"):
        self.mesh = mesh
        self.dp = dp_axes(mesh)
        self.n_dp = mesh.axis_size(self.dp) if self.dp else 1
        shapes = tr.init_params(cfg, device="meta")
        self.stored = param_pspecs(shapes, mesh, fsdp=tcfg.fsdp)
        live = self.stored
        if tcfg.local_grads:
            live = tree_map_with_path(lambda _, s: drop_axes(s, DP_AXES), live)
        self.live = spec_leaves(live)
        self.layout = compute_layout(cfg, mesh, live)
        self.stored_leaves = spec_leaves(self.stored)
        self.zspec = zero1.flat_spec(shapes, mesh.size) if tcfg.zero1 else None
        self.moment_specs = [moment_specs(x.shape, sp) for x, sp in
                             zip(tree_leaves(shapes), self.stored_leaves)]
        # the update reads whole gradients where ZeRO-1's flat slices or
        # the int8+EF link need them
        self.whole = tcfg.zero1 or tcfg.grad_compression
        self.local = tcfg.local_grads
        # the wire bytes of the whole float32 gradients (``dp_psum_bytes``)
        self.psum_bytes = compression.psum_bytes(
            [torch.empty(x.shape, dtype=torch.float32, device="meta")
             for x in tree_leaves(shapes)], compressed=False)

    def dp_group(self):
        return self.mesh.group(self.dp) if self.dp else None

    def reduce_data(self, grads) -> None:
        """Sum a microbatch's gradients over the data axes the backward has
        not summed them over (the group gather reduce-scatters over the
        axes a leaf is split on), one bucketed all-reduce a set of axes."""
        by_axes = {}
        for g, spec in zip(grads, self.live):
            if g is None:
                continue
            split = {a for e in spec if e is not None
                     for a in ((e,) if isinstance(e, str) else e)}
            axes = tuple(a for a in self.dp if a not in split)
            if axes:
                by_axes.setdefault(axes, []).append(g)
        for axes, gs in by_axes.items():
            col.all_reduce_many(gs, self.mesh.group(axes))

    def block(self, i: int, x):
        return shard(x, self.stored_leaves[i], self.mesh)

    def from_live(self, i: int, g):
        """Leaf i's stored block of its live block ``g`` (the same block but
        under ``local_grads``, whose live blocks are whole over the data
        axes)."""
        return shard(g, _data_splits(self.stored_leaves[i], self.mesh),
                     self.mesh) if self.local else g

    def reduce_squares(self, sqs) -> None:
        """Each live block's sum of squares summed, in place, over the ranks
        that hold the leaf's other blocks (the axes its live spec splits),
        so that the global norm is the whole gradients' (one bucketed
        all-reduce a set of axes)."""
        by_axes = {}
        for sq, spec in zip(sqs, self.live):
            split = {a for e in spec for a in entry_axes(e)}
            axes = tuple(a for a in self.mesh.axis_names if a in split)
            if axes:
                by_axes.setdefault(axes, []).append(sq)
        for axes, group in by_axes.items():
            col.all_reduce_many(group, self.mesh.group(axes))

    def dim_groups(self, i: int) -> tuple:
        """Per dim of leaf i's stored block, the process group of the ranks
        that hold its other blocks along that dim, or None where the dim is
        whole (Adafactor's means over a split dim)."""
        out = []
        for e in self.stored_leaves[i]:
            axes = entry_axes(e)
            out.append(self.mesh.group(axes) if axes and self.mesh.axis_size(axes) > 1
                       else None)
        return tuple(out)

    def moments(self):
        """Adafactor's ``moments`` hooks: every leaf's moments gathered
        whole (one bucketed round), and the blocks of new ones."""
        def whole(flat_s):
            keys = [(i, k) for i, s in enumerate(flat_s) for k in sorted(s)]
            got = gather_many([flat_s[i][k] for i, k in keys],
                              [self.moment_specs[i][k] for i, k in keys], self.mesh)
            out = [dict(s) for s in flat_s]
            for (i, k), x in zip(keys, got):
                out[i][k] = x
            return out

        def blocks(flat_s):
            return [{k: shard(v, self.moment_specs[i][k], self.mesh)
                     for k, v in s.items()} for i, s in enumerate(flat_s)]
        return whole, blocks


def prof_params(tcfg: TrainConfig) -> NeoProfParams:
    return NeoProfParams(sketch=SketchParams(width=tcfg.sketch_width))


def moment_specs(shape, spec) -> dict:
    """Adafactor's moments of a leaf of ``shape`` stored under ``spec``:
    ``vr`` under the spec without its last dim, ``vc`` without its second
    last (a factored leaf), else ``v`` under the spec itself."""
    if factored(shape):
        return {"vr": tuple(spec[:-1]), "vc": tuple(spec[:-2]) + tuple(spec[-1:])}
    return {"v": tuple(spec)}


def make_state_shapes(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(), mesh=None):
    """The train state on the meta device, no storage (the dry run's):
    :func:`init_state`'s tree over shape-only params; with a mesh, the
    rank's blocks of it."""
    return init_state(cfg, tcfg, tr.init_params(cfg, device="meta"), mesh=mesh)


def state_specs(state, mesh, fsdp: bool = False):
    """Where each leaf of a (global) train state rests over ``mesh``, a tree
    of specs like the state (the reference's ``state_shardings``): the
    params and AdamW's m and v by :func:`repro_torch.dist.sharding.param_pspecs`,
    Adafactor's moments by :func:`moment_specs`, ZeRO-1's flat vectors
    over every mesh axis, ``prof``, ``ef`` and every step whole.  (The
    reference places ``ef`` like the params; the port's compressed link
    runs on full gradients, so it keeps ``ef`` whole.)"""
    pspecs = param_pspecs(state["params"], mesh, fsdp=fsdp)
    whole = lambda _, x: (None,) * x.dim()
    opt = state["opt"]
    if "s" in opt:
        sl = [moment_specs(x.shape, sp) for x, sp in
              zip(tree_leaves(state["params"]), spec_leaves(pspecs))]
        ospecs = {"s": tree_unflatten(state["params"], sl), "step": ()}
    elif isinstance(opt.get("m"), dict):
        ospecs = {"m": pspecs, "v": pspecs, "step": ()}
    else:
        every = _entry(tuple(mesh.axis_names))
        ospecs = tree_map_with_path(
            lambda _, x: (every,) if x.dim() == 1 and x.shape[0] > 1 << 16
            else (None,) * x.dim(), opt)
    specs = {"params": pspecs, "opt": ospecs,
             "prof": tree_map_with_path(whole, state["prof"])}
    if "ef" in state:
        specs["ef"] = tree_map_with_path(whole, state["ef"])
    return specs


def init_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(), params=None,
               *, seed: int = 0, device="cuda", mesh=None):
    """The train state the reference's step takes: ``params`` (drawn from
    ``seed`` unless given), ``opt`` (the optimizer's state, or ZeRO-1's
    flat vectors), ``prof`` (a NeoProf state whose sketch has the
    reference's seeds) and, with ``grad_compression``, ``ef``.

    With a mesh (the counterpart of the reference's ``state_shardings``)
    ``params`` is the full tree, drawn on the mesh's device unless given,
    and the state holds the rank's blocks of it: the params and AdamW's
    moments under :func:`repro_torch.dist.sharding.param_pspecs` (with
    ``tcfg.fsdp``), Adafactor's moments under :func:`moment_specs`,
    ZeRO-1's slices (pinned on the host with ``offload_master`` on the
    card); ``ef`` and ``prof`` whole on every rank (:func:`state_specs`).  The params' blocks may share storage
    with the tree given."""
    if params is None:
        params = tr.init_params(cfg, seed, device=device if mesh is None
                                else mesh.device)
    dev = tree_leaves(params)[0].device
    pp = prof_params(tcfg)
    seeds = sk.key_seeds(pp.sketch.depth, pp.sketch.width)
    local = params
    if mesh is not None:
        local = _place_tree(params, param_pspecs(params, mesh, fsdp=tcfg.fsdp), mesh)
    state = {"params": local, "prof": neoprof_init(pp, seeds, device=dev)}
    if tcfg.zero1:
        state["opt"], _ = zero1.zero1_init(
            params, mesh, compress_collective=tcfg.compress_collective,
            offload=tcfg.offload_master)
    elif tcfg.opt.kind == "adafactor":
        state["opt"] = make_optimizer(tcfg.opt)[0](params)
        if mesh is not None:            # the moments' blocks (state_specs)
            sspecs = state_specs({"params": params, "opt": state["opt"],
                                  "prof": state["prof"]}, mesh, fsdp=tcfg.fsdp)
            state["opt"]["s"] = _place_tree(state["opt"]["s"], sspecs["opt"]["s"], mesh)
    else:
        state["opt"] = make_optimizer(tcfg.opt)[0](local)
    if tcfg.grad_compression:
        state["ef"] = compression.ef_init(params)
    return state


def _place_tree(tree, specs, mesh):
    """Every leaf's block under the matching spec of ``specs``."""
    return tree_unflatten(tree, [shard(x, sp, mesh) for x, sp in
                                 zip(tree_leaves(tree), spec_leaves(specs))])


def to_batch(batch: dict, device, mesh=None) -> dict:
    """A numpy batch (``data.pipeline``'s) as tensors on ``device``; with a
    mesh, the rank's rows (split over the data axes, as the reference's
    ``batch_shardings``)."""
    out = {k: tensor_from_numpy(np.ascontiguousarray(v), device)
           for k, v in batch.items()}
    if mesh is None:
        return out
    rows = batch_pspec(mesh)[0]
    return {k: shard(v, (rows,) + (None,) * (v.dim() - 1), mesh)
            for k, v in out.items()}


def build_train_step(cfg: ArchConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """-> ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``gnorm``, ``lr`` (() float32 tensors on the device), with
    ZeRO-1 ``collective_bytes``, and with ``local_grads`` over a mesh
    ``dp_psum_bytes`` (the wire bytes one rank adds to the data-parallel
    gradient sum).  Over a mesh ``state`` comes from ``init_state(...,
    mesh=mesh)`` and ``batch`` from ``to_batch(..., mesh=mesh)``."""
    _, opt_update = make_optimizer(tcfg.opt)
    pp = prof_params(tcfg)
    m = tcfg.microbatches
    spec = None             # ZeRO-1's flat layout: shapes only, built at step 1
    place = None if mesh is None else _Placement(cfg, mesh, tcfg)
    ep = _ep_context(cfg, mesh)
    local = place is not None and tcfg.local_grads

    def grads_and_loss(params, batch):
        leaves = tree_leaves(params)
        if local:           # the loop takes the params whole over the data axes
            leaves = gather_many(leaves, [_data_splits(st, mesh)
                                          for st in place.stored_leaves], mesh)
        live_leaves = [p.detach().requires_grad_() for p in leaves]
        live = tree_unflatten(params, live_leaves)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        streams = []
        kw = {} if place is None else {"ep_axes": ep, "layout": place.layout}
        for i in range(m):
            mb = {k: v[i::m] for k, v in batch.items()}
            loss, (_, aux) = tr.train_loss(cfg, live, mb, remat=tcfg.remat, **kw)
            grads = torch.autograd.grad(loss, live_leaves, allow_unused=True)
            with torch.no_grad():
                if place is not None and not local:
                    place.reduce_data(grads)
                for a, g in zip(gacc, grads):
                    if g is not None:      # a leaf off the loss's path: zero
                        a.add_(g)
                lsum = lsum + loss.detach()
            del grads, loss
            if "router_streams" in aux and not local:
                st = aux["router_streams"]
                if place is not None and place.dp:   # the whole microbatch's rows
                    st = col.all_gather(st, 2, place.dp_group())
                streams.append(st)
        return gacc, lsum, streams

    def block_grads(gacc):
        """The gradients as the live blocks they are (AdamW reads no more)
        -> (leaves, metrics); under ``local_grads`` the one data-parallel
        sum of the blocks runs here."""
        if not local:
            return gacc, {}
        metrics = {"dp_psum_bytes": place.psum_bytes}
        if place.dp:
            col.all_reduce_many(gacc, place.dp_group())
        return gacc, metrics

    def full_grads(gacc, state, new_state):
        """The gradients summed over the data axes, whole on every rank ->
        (leaves, metrics); under ``local_grads`` the one data-parallel sum
        (compressed with ``grad_compression``) runs here."""
        gl, j = [], 0
        while j < len(gacc):            # a bucket's float32 copies at a time
            k, size = j, 0
            while k < len(gacc) and (k == j or size + gacc[k].numel() * 4 <= col.BUCKET_BYTES):
                size += gacc[k].numel() * 4
                k += 1
            gl += gather_many(gacc[j:k], place.live[j:k], mesh)
            gacc[j:k] = [None] * (k - j)
            j = k
        if not local:
            return gl, {}
        metrics = {"dp_psum_bytes": compression.psum_bytes(
            gl, compressed=tcfg.grad_compression)}
        if not place.dp:
            return gl, metrics
        if tcfg.grad_compression:
            gl, new_state["ef"] = compression.compress_psum(
                gl, tree_leaves(state["ef"]), place.dp_group())
            new_state["ef"] = tree_unflatten(state["ef"], new_state["ef"])
        else:
            col.all_reduce_many(gl, place.dp_group())
        return gl, metrics

    def train_step(state, batch):
        nonlocal spec
        params, opt_state, prof = state["params"], state["opt"], state["prof"]
        pending = None
        if tcfg.zero1 and tcfg.offload_master:
            pending = zero1.fetch_opt(opt_state, mesh)
        gl, lsum, streams = grads_and_loss(params, batch)
        new_state = dict(state)
        metrics = {}
        if place is None:
            div = torch.tensor(float(m), device=lsum.device)
        else:
            gl, metrics = (full_grads(gl, state, new_state) if place.whole
                           else block_grads(gl))
            if place.dp:
                col.all_reduce(lsum, place.dp_group())
            div = torch.tensor(float(m * place.n_dp), device=lsum.device)
        for a in gl:
            a.div_(div)
        loss = lsum / div
        if tcfg.profile_experts and cfg.moe is not None and streams:
            page_stream = torch.stack(streams).reshape(-1)[:PROFILE_IDS]
            prof = neoprof_observe(prof, page_stream.to(torch.int32), pp)
        grads = tree_unflatten(params, gl)
        del gl
        if tcfg.grad_compression and not local:
            qs, new_state["ef"] = compression.compress_grads(grads, state["ef"])
            grads = compression.decompress_grads(qs)
            del qs
        if pending is not None:
            opt_state = pending.wait()
        if tcfg.zero1:
            if place is None:
                spec = spec or zero1.flat_spec(params)
            gl = tree_leaves(grads)
            del grads                   # the update lets go of each leaf it read
            params, opt_state, om = zero1.zero1_update(
                tcfg.opt, params, gl, opt_state, place.zspec if place else spec,
                mesh, compress_collective=tcfg.compress_collective,
                pspecs=place and place.stored)
            if pending is not None:
                opt_state = zero1.offload_opt(opt_state, mesh, into=pending.source)
        elif place is None:
            params, opt_state, om = opt_update(params, grads, opt_state)
        elif place.whole:
            params, opt_state, om = opt_update(params, grads, opt_state, place.block,
                                               moments=place.moments())
        else:
            params, opt_state, om = opt_update(params, grads, opt_state, place.from_live,
                                               norm=place.reduce_squares,
                                               groups=place.dim_groups)
        new_state.update(params=params, opt=opt_state, prof=prof)
        return new_state, {"loss": loss, **om, **metrics}

    return train_step


def _data_splits(spec, mesh) -> tuple:
    """``spec``'s splits over the data axes alone (a block that a single
    data rank holds is whole already)."""
    out = []
    for e in spec:
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        keep = axes and all(a in DP_AXES for a in axes) and mesh.axis_size(axes) > 1
        out.append(e if keep else None)
    return tuple(out)
