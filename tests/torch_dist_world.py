"""A gloo world of CPU ranks for the distribution-layer tests, and the
checks its ranks run (port side only: this module imports no JAX, so that
the spawned ranks start fast).

``World(checks)`` spawns ``WORLD`` processes (``spawn`` context, one
intra-op thread each) that join one gloo process group through a file
store in a temporary directory (no port is opened), build the meshes the
checks ask for and run every check in order; each returns plain numpy
results to the parent, which ``World.results()`` collects (rank -> {check
name: result}).  A check that raises records its traceback instead, and a
collective that waits for a failed rank gives up after ``TIMEOUT_S``.
The test files start the world in a module-scoped fixture, work out the
reference's oracles meanwhile, then compare.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import shutil
import tempfile
import traceback

import numpy as np

WORLD = 8
TIMEOUT_S = 120


class World:
    def __init__(self, checks, n: int = WORLD):
        """``checks``: (name, function name in this module, kwargs) triples."""
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="gloo-world-")
        self._q = ctx.Queue()
        self._n = n
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, self._dir, list(checks), self._q),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        self._results = None

    def results(self, timeout: float = 900.0) -> dict:
        if self._results is None:
            out = {}
            try:
                for _ in range(self._n):
                    rank, res = self._q.get(timeout=timeout)
                    out[rank] = res
            finally:
                self.close()
            self._results = out
        return self._results

    def close(self) -> None:
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)


def _contiguous_only(fn):
    """A collective that refuses strided buffers, as NCCL does (gloo takes
    them), so that the CPU ranks catch what the card would refuse."""
    import torch

    def run(*args, **kwargs):
        for t in args:
            if isinstance(t, torch.Tensor) and not t.is_contiguous():
                raise ValueError(f"{fn.__name__}: a strided buffer {tuple(t.shape)}")
        return fn(*args, **kwargs)
    return run


def _rank_main(rank, n, path, checks, q):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                 "reduce_scatter_single"):
        if hasattr(dist, name):
            setattr(dist, name, _contiguous_only(getattr(dist, name)))
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    meshes = _Meshes()
    out = {}
    mod = importlib.import_module(__name__)
    for name, fn, kw in checks:
        try:
            out[name] = getattr(mod, fn)(meshes, **kw)
        except Exception:                  # reported to the parent, per check
            out[name] = {"error": traceback.format_exc()}
    q.put((rank, out))
    dist.barrier()
    dist.destroy_process_group()


class _Meshes:
    """The world's meshes, built once each, in the order the checks ask."""

    def __init__(self):
        self._built = {}

    def __call__(self, name: str):
        if name not in self._built:
            from torch.distributed.device_mesh import init_device_mesh
            from repro_torch.launch.mesh import Mesh, make_mesh
            if name == "2x4":
                m = make_mesh((2, 4), ("data", "model"))
            elif name == "1x8":
                m = make_mesh((1, 8), ("data", "model"))
            elif name == "4x2":
                m = make_mesh((4, 2), ("data", "model"))
            elif name == "4x1":        # two (4, 1) meshes, one a half of the world
                dm = init_device_mesh("cpu", (2, 4, 1),
                                      mesh_dim_names=("rep", "data", "model"))
                m = Mesh(dm["data", "model"])
            elif name == "1x1":        # every rank a (1, 1) mesh of its own
                dm = init_device_mesh("cpu", (WORLD, 1, 1),
                                      mesh_dim_names=("rep", "data", "model"))
                m = Mesh(dm["data", "model"])
            else:
                raise KeyError(name)
            self._built[name] = m
        return self._built[name]


# -- helpers --------------------------------------------------------------------

def _t(a):
    import torch
    from repro_torch.convert import tensor_from_numpy
    return tensor_from_numpy(a, "cpu")


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_t(v) for v in tree]
    return _t(tree)


def _np(x):
    """A numpy copy (never a view of a tensor the check goes on writing)."""
    return (x.detach().float() if x.is_floating_point() else x).numpy().copy()


def _tree_np(tree):
    from repro_torch.ckpt.manager import tree_leaves
    return [_np(x) for x in tree_leaves(tree)]


def _place(tree, specs, mesh):
    """Every leaf's block under its spec."""
    from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
    from repro_torch.dist.sharding import shard, spec_leaves
    return tree_unflatten(tree, [shard(x, s, mesh) for x, s in
                                 zip(tree_leaves(tree), spec_leaves(specs))])


def _whole(tree, specs, mesh):
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.dist.sharding import gather, spec_leaves
    return [_np(gather(x, s, mesh)) for x, s in
            zip(tree_leaves(tree), spec_leaves(specs))]


# -- checks of tests/test_torch_dist.py -------------------------------------------

SHARD_SPECS = [("data", "model", None), (None, ("data", "model"), None),
               ("model", None, "data"), (None, None, None), (("data", "model"), None, None)]


def check_shard_gather(meshes, full):
    """Every spec's block gathered back, on the (2, 4) and (1, 8) meshes."""
    x = _t(full)
    from repro_torch.dist.sharding import gather, shard
    out = []
    for name in ("2x4", "1x8"):
        mesh = meshes(name)
        for spec in SHARD_SPECS:
            back = gather(shard(x, spec, mesh), spec, mesh)
            out.append((name, spec, bool(back.shape == x.shape and (back == x).all())))
    return out


def check_compress_psum(meshes, grads, ef):
    """compress_psum over the (2, 4) mesh's 'model' ranks (4), each rank's
    gradients ``grads[coordinate]``."""
    from repro_torch.dist.compression import compress_psum
    mesh = meshes("2x4")
    mine = _tree_t(grads[mesh.coord("model")])
    total, new_ef = compress_psum(mine, _tree_t(ef), mesh.group("model"))
    return {"sum": _tree_np(total), "ef": _tree_np(new_ef)}


def check_pipeline(meshes, w, b, x, ct):
    """pipeline_apply over the (2, 4) mesh's 'model' axis: 4 stages, each a
    tree (a nested dict and a list); y, and the gradients of sum(y * ct)
    with respect to the stage weights (gathered over 'model') and x."""
    import torch
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.dist.sharding import shard
    mesh = meshes("2x4")
    stage = {"lin": {"w": shard(_t(w), ("model", None, None), mesh).requires_grad_()},
             "bias": [shard(_t(b), ("model", None), mesh).requires_grad_()]}
    xt = _t(x).requires_grad_()
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["lin"]["w"] + p["bias"][0]),
                       stage, xt, mesh=mesh, axis="model")
    (y * _t(ct)).sum().backward()
    group = mesh.group("model")
    return {"y": _np(y), "x": _np(xt.grad),
            "w": _np(all_gather(stage["lin"]["w"].grad, 0, group)),
            "b": _np(all_gather(stage["bias"][0].grad, 0, group))}


def check_combine_stats(meshes, q, k_pages, v_pages, page_lengths, softcap):
    """The slot-split attention over the (2, 4) mesh's 'model' ranks:
    local stats and combine, with and without the page stats."""
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.sharding import shard
    from repro_torch.kernels.paged_attn import ops
    mesh = meshes("2x4")
    group = mesh.group("model")
    kp = shard(_t(k_pages), (None, "model"), mesh)
    vp = shard(_t(v_pages), (None, "model"), mesh)
    pl = shard(_t(page_lengths), (None, "model"), mesh)
    qt = _t(q)
    out = ops.combine_stats(*ops.paged_attention_local_stats(qt, kp, vp, pl,
                                                             softcap=softcap), group)
    m, l, acc, pm, pls = ops.paged_attention_local_stats(qt, kp, vp, pl, softcap=softcap,
                                                         return_page_stats=True)
    out2, mass = ops.combine_stats(m, l, acc, group, page_m=pm, page_l=pls)
    return {"out": _np(out), "out_mass": _np(out2),
            "mass": _np(all_gather(mass, 1, group))}


def check_sharded_decode(meshes, params, tokens, n_slots, page_t,
                         arch="llama3.2-3b", mesh="2x4"):
    """decode_step_paged with the ring's slots over ``mesh``'s 'model'
    ranks, float32, one teacher-forced token column a step; as the dry
    run's long_500k cell runs it (the slots over both axes, the params
    stored under param_pspecs, a group gathered before it runs and
    partitioned over 'model', ``layout``, a MoE arch's experts
    expert-parallel); and the same steps without a mesh.  ``first_k`` /
    ``first_v`` are the first ring's pages (a MoE arch's first prologue
    layer, else the body's first group), which no attention output
    reaches; ``states`` every recurrent position's decode state."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.sharding import cache_pspecs, param_pspecs
    from repro_torch.models import decode as dec
    from repro_torch.train.step import _ep_context, compute_layout
    cfg = get_smoke_config(arch)
    mesh = meshes(mesh)
    p = _tree_t(params)
    b = tokens.shape[0]
    out = {}
    for arm, axes, stored in (("sharded", ("model",), False),
                              ("layout", ("data", "model"), True),
                              ("meshless", None, False)):
        smesh = {"mesh": mesh, "axes": axes} if axes else None
        cache = dec.init_paged_cache(cfg, b, n_slots, page_t, dtype=torch.float32,
                                     device="cpu")
        if smesh:
            cache = _place(cache, cache_pspecs(cache, mesh, slot_axes=axes), mesh)
        pp, layout, ep = p, None, None
        if stored:
            pspecs = param_pspecs(p, mesh)
            pp, layout = _place(p, pspecs, mesh), compute_layout(cfg, mesh, pspecs)
            ep = _ep_context(cfg, mesh)
        logits, masses = [], []
        for t in range(tokens.shape[1]):
            lg, cache, st = dec.decode_step_paged(cfg, pp, cache, _t(tokens[:, t:t + 1]),
                                                  page_t=page_t, return_streams=True,
                                                  smesh=smesh, layout=layout, ep_axes=ep)
            logits.append(_np(lg))
            mass = st["kv_mass"]
            if mass is not None:
                masses.append(_np(all_gather(mass, 3, mesh.group(axes)) if smesh
                                  else mass))
        out[arm] = {"logits": np.stack(logits), "pos": _np(cache["pos"]),
                    "states": {f"{i}/{k}": _np(v) for i, b in enumerate(cache["blocks"])
                               if "k_pages" not in b for k, v in b.items()}}
        ring = _first_ring(cache["blocks"])
        if ring is None:               # an attention-free arch (xlstm)
            continue
        blk = cache["blocks"][ring]
        whole = ((lambda x, d=2: all_gather(x, d, mesh.group(axes))) if smesh
                 else (lambda x, d=2: x))
        first = (cache["prologue"][0] if "prologue" in cache
                 else {k: v[0] for k, v in blk.items()})
        out[arm].update({"kv_mass": np.stack(masses),
                         "page_len": _np(whole(blk["page_len"])),
                         "cur_slot": _np(blk["cur_slot"]),
                         "k_pages": _np(whole(blk["k_pages"])),
                         "v_pages": _np(whole(blk["v_pages"])),
                         "first_k": _np(whole(first["k_pages"], 1)),
                         "first_v": _np(whole(first["v_pages"], 1))})
    return out


def _first_ring(blocks):
    """The first pattern position with a paged ring, or None."""
    return next((i for i, b in enumerate(blocks) if "k_pages" in b), None)


def check_cell_serving(meshes, params, tokens, prompt, arch="llama3.2-3b",
                       mesh="2x4"):
    """The dry run's prefill_32k and decode_32k callables
    (:func:`repro_torch.launch.specs.cell_specs` at ``arch``'s smoke
    config, B 2) on values, float32, over ``mesh`` and without one.
    Over the mesh the params rest under the cell's specs and each group
    gathers them and computes its share over 'model' (``layout``); decode
    runs over the dense cache, its sequence split over 'model', each
    block's core attending over the rank's block of it and the ranks
    merging their softmax statistics (``cache_layout``; nothing of the
    cache gathered), one teacher-forced token column a step until the
    cache is full.  Returns the prefill's and every step's logits (rows
    gathered over 'data'), the final cache's first body block, gathered,
    and the mesh arm's ``decode.CACHE_LEAVES`` counts."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.sharding import gather, shard
    from repro_torch.launch.specs import cell_specs
    from repro_torch.models import decode as dec
    cfg = get_smoke_config(arch)
    mesh = meshes(mesh)
    dgroup = mesh.group("data")
    full = _tree_t(params)
    b, s = tokens.shape
    out = {}
    for arm, m in (("mesh", mesh), ("meshless", None)):
        rows = (lambda x: all_gather(x, 0, dgroup)) if m else (lambda x: x)
        pre = cell_specs(arch, "prefill_32k", m, cfg=cfg, batch=b, seq=prompt.shape[1])
        cell = cell_specs(arch, "decode_32k", m, cfg=cfg, batch=b, seq=s)
        cache = dec.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
        pp, batch = full, {"tokens": _t(prompt)}
        column = lambda t: _t(tokens[:, t:t + 1])
        if m:
            pspec, cspec, tspec = cell["specs"]
            pp, cache = _place(full, pspec, m), _place(cache, cspec, m)
            batch = _place(batch, pre["specs"][1], m)
            column = lambda t: shard(_t(tokens[:, t:t + 1]), tspec, m)
        res = {"prefill": _np(rows(pre["fn"](pp, batch)))}
        before = dict(dec.CACHE_LEAVES)
        res["logits"] = np.stack([_np(rows(cell["fn"](pp, cache, column(t))))
                                  for t in range(s)])
        res["cache_leaves"] = {k: v - before[k] for k, v in dec.CACHE_LEAVES.items()}
        blk = cache["blocks"][0]
        for k in blk:
            res[k] = _np(gather(blk[k], cspec["blocks"][0][k], m) if m else blk[k])
        res["pos"] = _np(cache["pos"])
        out[arm] = res
    return out


def check_partitioned_layers(meshes, kind, p, x, ct, kw):
    """One partitioned layer over the (2, 4) mesh's 'model' ranks (4): the
    rank's blocks of ``p`` (column weights' last dim, row weights' and the
    table's first), a ``Part`` of 'model', and the output with the
    gradients of sum(y * ct) (``kind`` "head": the vocab-parallel loss of
    ``ct``'s labels under its mask plus sum(embedding * x), the logits
    gathered whole; "mla-decode": MLA's absorbed decode over ``ct``'s
    dense cache at ``ct["pos"]``, the output and the cache it wrote, no
    gradients; "attn-decode": GQA's, over the rank's block of the
    cache's sequence, with the meshless decode's write of that block, and
    "mla-decode" over it where ``ct["split"]``; "mamba2", "mlstm",
    "slstm": a recurrent mixer, its replicated leaves and the weights whose
    dim does not divide the ranks whole; "cross": cross attention over ``kw["kv"]``, whose gradient is
    returned too); the blocks' gradients gathered over 'model'."""
    import torch
    from repro_torch.dist.collectives import Part, all_gather
    from repro_torch.models import attention, layers, mamba2, moe, xlstm
    mesh = meshes("2x4")
    part = Part(mesh.group("model"), mesh.coord("model"), mesh.axis_size("model"))
    # param_pspecs' rule: a dim that does not divide the ranks stays whole
    dims = {k: (0 if k in ("wo", "w_out", "sh_out", "table", "out_proj") else -1)
            for k, v in p.items() if v.ndim >= 2}
    dims = {k: d for k, d in dims.items()
            if p[k].shape[d] >= part.size and p[k].shape[d] % part.size == 0}
    local = {k: (part.block(_t(v), dims[k]) if k in dims else _t(v)).clone()
             .requires_grad_() for k, v in p.items()}
    xt = _t(x).requires_grad_()
    out = {}
    if kind == "cross":
        kw = dict(kw)
        kv = _t(kw.pop("kv")).requires_grad_()
    if kind in ("mla-decode", "attn-decode"):
        keys = ("c_kv", "k_rope") if kind == "mla-decode" else ("k", "v")
        layer = attention.mla_decode if kind == "mla-decode" else attention.gqa_decode
        split = kind == "attn-decode" or ct["split"]
        pos = torch.tensor(ct["pos"])
        cache = {k: (part.block(_t(ct[k]), 1) if split else _t(ct[k])).clone()
                 for k in keys}
        with torch.no_grad():
            y = layer(local, xt, cache, pos, part=part, seq=part if split else None, **kw)
        out = {"y": _np(y), "coord": part.rank, **{k: _np(cache[k]) for k in keys}}
        if split:                      # the meshless decode's write, the rank's block
            whole = {k: _t(ct[k]).clone() for k in keys}
            with torch.no_grad():
                layer(_tree_t(p), xt, whole, pos, **kw)
            out.update({f"{k}_meshless": _np(part.block(whole[k], 1)) for k in keys})
        return out
    if kind == "head":
        logits = layers.logits_apply(local, xt, kw["softcap"], part)
        loss = layers.cross_entropy(logits, _t(ct["labels"]).long(), _t(ct["mask"]), part)
        emb = layers.embed_apply(local, _t(ct["tokens"]).long(), part)
        (loss + (emb * xt).sum()).backward()
        out["y"] = _np(loss)
        out["logits"] = _np(layers.gather_logits(logits, part))
    else:
        if kind == "attn":
            y = attention.gqa_apply(local, xt, part=part, **kw)
        elif kind == "cross":
            y = attention.cross_apply(local, xt, kv, part=part, **kw)
        elif kind == "mla":
            y = attention.mla_apply(local, xt, part=part, **kw)
        elif kind == "shared":
            y = moe._shared_expert(local, xt, part)
        elif kind == "mamba2":
            y = mamba2.mamba2_apply(local, xt, part=part, **kw)
        elif kind == "mlstm":
            y = xlstm.mlstm_apply(local, xt, part=part, **kw)
        elif kind == "slstm":
            y = xlstm.slstm_apply(local, xt, part=part)
        else:
            y = layers.mlp_apply(local, xt, kw["mlp"], part=part)
        (y * _t(ct)).sum().backward()
        out["y"] = _np(y)
    out["grads"] = {k: _np(all_gather(v.grad, dims[k] % v.dim(), part.group)
                           if k in dims else v.grad) for k, v in local.items()}
    out["grads"]["x"] = _np(xt.grad)
    if kind == "cross":
        out["grads"]["kv"] = _np(kv.grad)
    return out


def check_moe_ep(meshes, p, x, ct, k, bias):
    """moe_apply_ep expert-parallel on the (2, 4) mesh (capacity factor 8):
    the tokens' rows over 'data', the experts over 'model' and their dim 1
    over 'data'; y, ids and every gradient of sum(y * ct), gathered."""
    import torch
    from repro_torch.dist.collectives import all_gather, all_reduce
    from repro_torch.dist.sharding import gather, shard
    from repro_torch.models import moe
    mesh = meshes("2x4")
    ep = moe.EPContext(mesh=mesh, expert_axis="model", fsdp_axis="data",
                       dp_axes=("data",), capacity_factor=8.0)
    wspec = ("model", "data", None)
    full = _tree_t(p)
    local = {kk: (shard(v, wspec, mesh) if kk.startswith("w_") else v)
             for kk, v in full.items()}
    local = {kk: v.clone().requires_grad_() for kk, v in local.items()}
    rows = lambda a: shard(_t(a), ("data", None, None), mesh)
    xl = rows(x).requires_grad_()
    y, idx, _ = moe.moe_apply_ep(local, xl, k, bias=None if bias is None else _t(bias),
                                 ep_axes=ep)
    (y * rows(ct)).sum().backward()
    dgroup = mesh.group("data")
    grads = {}
    for kk, v in local.items():
        if kk.startswith("w_"):        # summed over 'data' by the gather's backward
            grads[kk] = _np(gather(v.grad, wspec, mesh))
        else:                          # this data shard's part
            grads[kk] = _np(all_reduce(v.grad.clone(), dgroup))
    grads["x"] = _np(all_gather(xl.grad, 0, dgroup))
    return {"y": _np(all_gather(y.detach(), 0, dgroup)),
            "idx": _np(all_gather(idx, 0, dgroup)), "grads": grads}


def check_moe_resident(meshes, rp, x, k, bias):
    """The "residency" arm expert-parallel on the (2, 4) mesh: hot slots,
    fetch buffers and fetch ids split over 'model', the tokens whole."""
    from repro_torch.dist.sharding import shard
    from repro_torch.models import moe
    mesh = meshes("2x4")
    ep = moe.EPContext(mesh=mesh, expert_axis="model", fsdp_axis=None, dp_axes=())
    p = {kk: (shard(v, ("model",) + (None,) * (v.dim() - 1), mesh)
              if kk.startswith(("w_", "fetch_")) else v)
         for kk, v in _tree_t(rp).items()}
    y, idx, _ = moe.moe_apply_ep(p, _t(x), k, bias=None if bias is None else _t(bias),
                                 ep_axes=ep)
    return {"y": _np(y), "idx": _np(idx)}


def check_zero1(meshes, params, grads, opt, compress, offload):
    """ZeRO-1 over the 8 ranks of the (2, 4) mesh, the params stored under
    param_pspecs with fsdp: 3 updates of the same full gradients on every
    rank; m and v gathered from the slices, the params from the blocks."""
    import torch
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.sharding import param_pspecs
    from repro_torch.optim import zero1
    from repro_torch.optim.optimizers import OptConfig
    mesh = meshes("2x4")
    full = _tree_t(params)
    specs = param_pspecs(full, mesh, fsdp=True)
    local = _place(full, specs, mesh)
    state, spec = zero1.zero1_init(full, mesh, compress_collective=compress,
                                   offload=offload)
    cfg = OptConfig(**opt)
    for g in grads:
        pending = zero1.fetch_opt(state, mesh) if offload else None
        if pending is not None:
            state = pending.wait()
        local, state, om = zero1.zero1_update(cfg, local, _tree_t(g), state, spec,
                                              mesh, compress_collective=compress,
                                              pspecs=specs)
        if offload:
            state = zero1.offload_opt(state, mesh, into=pending.source)
    group = mesh.group(mesh.axis_names)
    out = {k: _np(all_gather(v, 0, group)) for k, v in state.items() if k != "step"}
    out["step"] = int(state["step"])
    out["params"] = _whole(local, specs, mesh)
    out["collective_bytes"] = om["collective_bytes"]
    out["padded"] = spec.padded
    return out


# -- checks of tests/test_torch_dist_train.py -------------------------------------

def check_train(meshes, mesh, arch, params, batches, kw, opt):
    """Two train steps over ``mesh`` from the full float32 ``params``: the
    losses, gradient norms and ``dp_psum_bytes``, the params gathered, the
    rank's own copies of the replicated params (norms, biases), the leaves
    that computed split over 'model' and those gathered whole, the
    sketch's arrays and ``ef``."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist.sharding import param_pspecs
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import step as ts
    cfg = get_smoke_config(arch)
    msh = meshes(mesh)
    tcfg = ts.TrainConfig(opt=OptConfig(**opt), **kw)
    full = _tree_t(params)
    state = ts.init_state(cfg, tcfg, full, device="cpu", mesh=msh)
    fn = ts.build_train_step(cfg, msh, tcfg)
    metrics = []
    for b in batches:
        state, m = fn(state, ts.to_batch(b, "cpu", mesh=msh))
        metrics.append({k: (float(v) if hasattr(v, "dim") else v) for k, v in m.items()})
    prof = state["prof"]
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.dist.sharding import spec_leaves
    specs = param_pspecs(full, msh, fsdp=tcfg.fsdp)
    layout = ts.compute_layout(cfg, msh, specs)
    return {"metrics": metrics,
            "replicated": [_np(x) for x, sp in zip(tree_leaves(state["params"]),
                                                   spec_leaves(specs))
                           if all(e is None for e in sp)],
            "split": ts.split_counts(layout, specs),
            "params": _whole(state["params"], specs, msh),
            "sketch": [_np(getattr(prof.sketch, f)) for f in ("counts", "epochs", "hot",
                                                              "n_seen")]
            + [_np(prof.hot_buf), _np(prof.hot_count)],
            "ef": _tree_np(state["ef"]) if "ef" in state else None}


def check_one_rank(meshes, arch, params, batches, prompt, aux=None):
    """At one 'model' rank (rank 0's own (1, 1) mesh; the other ranks only
    join its making): two float32 train steps of ``arch``'s smoke config
    over the mesh, AdamW and Adafactor (2 microbatches, remat), with the
    expert-parallel body off (its ``enter`` regroups x's gradient sum),
    against the meshless step; then, the experts expert-parallel,
    ``prefill_paged`` of ``prompt`` and 4 greedy paged decode steps,
    ``prefill_dense`` (the dense cache under ``cache_pspecs``, its sequence
    split over the one 'model' rank: ``cache_layout``; the attention-cache
    leaves attended split returned as "dense_split") and ``prefill`` with
    ``layout`` (over ``aux``, a
    cross-attention arch's patches or frames; an encoder arch's ``encode``d
    first, its output compared too) against the meshless calls.  Returns,
    per arm, the count of leaves (params; logits and cache leaves) that
    differ at all."""
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt.manager import tree_leaves
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist.sharding import (DP_AXES, Layout, cache_pspecs, drop_axes,
                                           param_pspecs, tree_map_with_path)
    from repro_torch.models import decode as dec
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import step as ts
    mesh = meshes("1x1")
    if dist.get_rank() != 0:
        return {}
    cfg = get_smoke_config(arch)
    out = {}
    ep_context = ts._ep_context
    ts._ep_context = lambda cfg, mesh: None
    try:
        for kind in ("adamw", "adafactor"):
            tcfg = ts.TrainConfig(opt=OptConfig(kind=kind, lr=1e-2, warmup_steps=1),
                                  microbatches=2)
            arms = []
            for msh in (None, mesh):
                state = ts.init_state(cfg, tcfg, _tree_t(params), device="cpu", mesh=msh)
                fn = ts.build_train_step(cfg, msh, tcfg)
                for b in batches:
                    state, _ = fn(state, ts.to_batch(b, "cpu", mesh=msh))
                arms.append(tree_leaves(state["params"]))
            out[kind] = sum(not torch.equal(a, b) for a, b in zip(*arms))
    finally:
        ts._ep_context = ep_context
    full = _tree_t(params)
    pspecs = param_pspecs(full, mesh)
    stored, layout = _place(full, pspecs, mesh), ts.compute_layout(cfg, mesh, pspecs)
    tok = _t(prompt).long()
    arms = []
    for p, kw in ((full, {}), (stored, dict(layout=layout, ep_axes=ts._ep_context(cfg, mesh)))):
        got = []
        src = None if aux is None else _t(aux)
        if src is not None and cfg.encoder_layers:
            from repro_torch.models.transformer import encode
            src = encode(cfg, p, src, **kw)
            got.append(src)
        xkw = {} if aux is None else dict(aux_embeds=src)
        cache = dec.init_paged_cache(cfg, 2, 4, 4, dtype=torch.float32, device="cpu")
        last, cache, _ = dec.prefill_paged(cfg, p, cache, tok, page_t=4, **kw)
        got.append(last)
        t = last.argmax(-1, keepdim=True)
        for _ in range(4):
            lg, cache = dec.decode_step_paged(cfg, p, cache, t, page_t=4, **kw)
            got.append(lg)
            t = lg[:, -1].argmax(-1, keepdim=True)
        got += tree_leaves(cache)
        dense = dec.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        dkw = {}
        if kw:                         # the sequence split over the one 'model' rank
            cspecs = cache_pspecs(dense, mesh)
            dense = _place(dense, cspecs, mesh)
            dkw = dict(cache_layout=Layout(mesh, tree_map_with_path(
                lambda _, sp: drop_axes(sp, DP_AXES), cspecs)))
            before = dec.CACHE_LEAVES["split"]
        last, dense, _ = dec.prefill_dense(cfg, p, dense, tok, **kw, **xkw, **dkw)
        if kw:
            out["dense_split"] = dec.CACHE_LEAVES["split"] - before
        got += [last] + tree_leaves(dense)
        got.append(dec.prefill(cfg, p, tok, **kw,
                               **({} if aux is None else dict(aux_embeds=_t(aux))))[0])
        arms.append(got)
    out["serve"] = sum(not torch.equal(a, b) for a, b in zip(*arms))
    out["n_serve"] = len(arms[0])
    return out
