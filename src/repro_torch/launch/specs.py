"""The dry run's cells: one (arch x shape x mesh [x variant]) each (port of
``repro/launch/specs.py``).

:func:`cell_specs` returns, per cell, the callable a rank runs, the rank's
arguments as meta tensors (shapes and dtypes, no storage), the global
trees they are blocks of and the spec of every leaf
(:mod:`repro_torch.dist.sharding`'s, ``PartitionSpec``'s layout):

  train_4k      -> train_step(state, batch)
  prefill_32k   -> prefill(params, batch)
  decode_32k    -> decode_step(params, cache, token[, aux])  (full KV cache)
  long_500k     -> decode_step_paged(params, cache, token)   (NeoMem fast tier)

Over a mesh the callable is the port's per-rank code: each pattern group
gathers its stored weights (:class:`repro_torch.dist.sharding.Layout`), a
dense decoder's, a MoE arch's or a recurrent arch's embedding, attention,
MLPs, shared experts, recurrent mixers and head computing the rank's share
over 'model'
(``train.step.compute_layout``), the MoE layers' experts run
expert-parallel, decode_32k's cores attend over the rank's block of the
sequence-split cache (the ranks merge their softmax statistics),
long_500k splits the ring's page slots over every mesh axis (B = 1).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, cell_is_skipped
from repro_torch.configs.registry import get_config
from repro_torch.dist.sharding import (Layout, batch_pspec, cache_pspecs, drop_axes,
                                       param_pspecs, tree_map_with_path)
from repro_torch.launch.mesh import DP_AXES, Mesh, axis_size
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tr
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train import step as train_step_mod

PAGE_T = 256            # tokens per KV page (NeoMem tiering page)
HOT_SLOTS = 512         # fast-tier page slots per layer (long_500k)
HOT_EXPERT_FRAC = 16    # E_hot = E / frac resident (NeoMem fast tier)
N_FETCH = 16            # cold experts fetched per interval (1 per EP shard)
VARIANTS = (None, "tiered_experts", "fsdp", "local_grads")


def _dp(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def _microbatches(cfg: ArchConfig, global_batch: int, seq: int, mesh) -> int:
    """Grad-accumulation factor: keep per-device microbatch tokens ~<= 8K."""
    dp = math.prod(mesh.shape[a] for a in _dp(mesh)) if mesh is not None else 1
    per_dev_rows = max(1, global_batch // dp)
    target_rows = max(1, (8192 + seq - 1) // seq)
    m = max(1, per_dev_rows // target_rows)
    while per_dev_rows % m:
        m -= 1
    return m


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tiered_expert_params(cfg: ArchConfig, params, specs, mesh) -> None:
    """Swap the full expert stacks for NeoMem fast-tier residents, in
    place: (G, E, D, F) -> hot (G, E_hot, D, F) split over 'model', fetch
    buffers (G, N_FETCH, D, F) and ids split over 'model', and the
    residency map (G, E), whole: the params ``models/moe.py``'s residency
    arm reads."""
    e = cfg.moe.n_experts
    e_hot = max(mesh.shape["model"] if mesh is not None else 1, e // HOT_EXPERT_FRAC)
    g, d, f = cfg.n_groups, cfg.d_model, cfg.moe.expert_ff
    ep = (None, "model", None, None)
    for blk, bspec in zip(params["blocks"], specs["blocks"]):
        ffn = blk.get("ffn")
        if ffn is None or "w_gate" not in ffn or ffn["w_gate"].dim() < 4:
            continue
        new = {"w_gate": ((g, e_hot, d, f), ep), "w_in": ((g, e_hot, d, f), ep),
               "w_out": ((g, e_hot, f, d), ep),
               "fetch_gate": ((g, N_FETCH, d, f), ep),
               "fetch_in": ((g, N_FETCH, d, f), ep),
               "fetch_out": ((g, N_FETCH, f, d), ep)}
        for k, (shape, spec) in new.items():
            ffn[k] = _meta(shape, torch.bfloat16)
            bspec["ffn"][k] = spec
        ffn["fetch_ids"] = _meta((g, N_FETCH), torch.int32)
        bspec["ffn"]["fetch_ids"] = (None, "model")
        ffn["residency"] = _meta((g, e), torch.int32)
        bspec["ffn"]["residency"] = (None, None)


def spec_map(tree) -> dict:
    """{path: leaf} of a tree (a spec tree's leaves are its specs)."""
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-rank block shape of a tensor of ``shape`` under ``spec``;
    raises ValueError where a split dim does not divide (as
    ``NamedSharding.shard_shape`` does)."""
    out = []
    for d, e in zip(shape, spec):
        n = axis_size(mesh, e)
        if d % n:
            raise ValueError(f"spec {tuple(spec)} splits dim {d} of {tuple(shape)} "
                             f"{n} ways: it does not divide")
        out.append(d // n)
    return tuple(out) + tuple(shape[len(out):])


def local_args(tree, specs, mesh):
    """The rank's blocks of a global meta tree, as meta tensors."""
    if mesh is None:
        return tree
    at = spec_map(specs)
    return tree_map_with_path(
        lambda p, x: _meta(shard_shape(x.shape, at[p], mesh), x.dtype), tree)


def _whole(tree):
    return tree_map_with_path(lambda _, x: (None,) * x.dim(), tree)


def cell_specs(arch: str, shape_name: str, mesh, *, tcfg=None,
               variant: str | None = None, cfg: ArchConfig | None = None,
               batch: int | None = None, seq: int | None = None) -> dict[str, Any]:
    """One dry-run cell -> ``{"fn", "args", "global", "specs", "label",
    "cfg"[, "tcfg"]}``, or ``{"skip": reason}``.

    ``mesh``: a :class:`repro_torch.launch.mesh.Mesh` over a world (``fn``
    runs on that rank's ``args``), a :class:`~repro_torch.launch.mesh.MeshShape`
    (the specs alone: ``fn`` is None) or None (one device, no specs).
    ``args`` are the rank's blocks of ``global`` under ``specs`` (tuples of
    trees), all on the meta device.  variants: None (baseline),
    'tiered_experts', 'fsdp', 'local_grads'.  ``cfg``, ``batch`` and ``seq``
    stand in for the arch's config and the shape's global batch and
    sequence length (a smaller cell through the same path)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; {VARIANTS}")
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        return {"skip": skip}
    cfg = cfg or get_config(arch)
    shp = SHAPES[shape_name]
    b, s = batch or shp["global_batch"], seq or shp["seq_len"]
    run_mesh = mesh if isinstance(mesh, Mesh) else None
    runs = mesh is None or run_mesh is not None
    label = f"{arch}:{shape_name}"
    fsdp = variant == "fsdp"
    bspec = batch_pspec(mesh) if mesh is not None else (None, None)
    rows = bspec[0]

    def out(fn, glob, specs, **extra):
        args = tuple(local_args(t, sp, mesh) for t, sp in zip(glob, specs))
        return {"fn": fn if runs else None, "args": args, "global": glob,
                "specs": specs if mesh is not None else None, "label": label,
                "cfg": cfg, **extra}

    def batch_tree(kinds):
        t = {k: _meta((b, s), torch.int32) for k in kinds}
        sp = {k: bspec for k in kinds}
        if cfg.n_aux_tokens:
            t["aux_embeds"] = _meta((b, cfg.n_aux_tokens, cfg.d_model), torch.bfloat16)
            sp["aux_embeds"] = (rows, None, None)
        return t, sp

    if shp["kind"] == "train":
        tcfg = tcfg or train_step_mod.TrainConfig(
            opt=OptConfig(kind="adafactor" if cfg.moe else "adamw"),
            microbatches=_microbatches(cfg, b, s, mesh),
            local_grads=variant == "local_grads", fsdp=fsdp)
        state = train_step_mod.make_state_shapes(cfg, tcfg)
        sspecs = (train_step_mod.state_specs(state, mesh, fsdp=fsdp)
                  if mesh is not None else _whole(state))
        bt, bsp = batch_tree(("tokens", "labels"))
        fn = train_step_mod.build_train_step(cfg, run_mesh, tcfg) if runs else None
        return out(fn, (state, bt), (sspecs, bsp), tcfg=tcfg)

    params = tr.init_params(cfg, device="meta")
    pspecs = (param_pspecs(params, mesh, fsdp=fsdp) if mesh is not None
              else _whole(params))
    if variant == "tiered_experts":
        if cfg.moe is None:
            raise ValueError("tiered_experts needs a MoE arch")
        _tiered_expert_params(cfg, params, pspecs, mesh)
    ep = train_step_mod._ep_context(cfg, run_mesh)
    layout = (train_step_mod.compute_layout(cfg, run_mesh, pspecs)
              if run_mesh is not None else None)

    if shp["kind"] == "prefill":
        bt, bsp = batch_tree(("tokens",))

        def fn(params, batch):
            logits, _ = dec.prefill(cfg, params, batch["tokens"],
                                    aux_embeds=batch.get("aux_embeds"),
                                    ep_axes=ep, layout=layout)
            return logits
        return out(fn, (params, bt), (pspecs, bsp))

    if shp["kind"] == "decode":
        cache = dec.init_cache(cfg, b, s, dtype=torch.bfloat16, device="meta")
        # batch over the data axes, the k/v sequence over 'model'; each
        # block's core attends over the rank's block of the sequence
        cspecs = cache_pspecs(cache, mesh) if mesh is not None else _whole(cache)
        cache_layout = (Layout(run_mesh, tree_map_with_path(
            lambda _, sp: drop_axes(sp, DP_AXES), cspecs))
            if run_mesh is not None else None)
        glob = (params, cache, _meta((b, 1), torch.int32))
        specs = (pspecs, cspecs, bspec)
        if cfg.n_aux_tokens:
            glob += (_meta((b, cfg.n_aux_tokens, cfg.d_model), torch.bfloat16),)
            specs += ((rows, None, None),)

        def fn(params, cache, token, aux_embeds=None):
            logits, _ = dec.decode_step(cfg, params, cache, token,
                                        aux_embeds=aux_embeds, ep_axes=ep,
                                        layout=layout, cache_layout=cache_layout)
            return logits
        return out(fn, glob, specs)

    # long_500k paged decode: the page slots over every mesh axis (B = 1)
    cache = dec.init_paged_cache(cfg, b, HOT_SLOTS, PAGE_T, dtype=torch.bfloat16,
                                 device="meta")
    slot_axes = tuple(mesh.axis_names) if mesh is not None else None
    cspecs = (cache_pspecs(cache, mesh, slot_axes=slot_axes) if mesh is not None
              else _whole(cache))
    smesh = {"mesh": run_mesh, "axes": slot_axes} if run_mesh is not None else None

    def fn(params, cache, token):
        logits, _ = dec.decode_step_paged(cfg, params, cache, token, page_t=PAGE_T,
                                          ep_axes=ep, smesh=smesh, layout=layout)
        return logits
    return out(fn, (params, cache, _meta((b, 1), torch.int32)),
               (pspecs, cspecs, (None, None)))
