"""The train step on one device (port of ``repro/train/step.py``).

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
     ``compress_collective`` its int8+EF delta; ``offload_master`` is the
     identity on one device).

The state is ``{"params", "opt", "prof"[, "ef"]}``, the reference's tree
(:func:`init_state` builds it).  The step writes the params and optimizer
moments in place and returns the state.  Every tensor lives on the state's
device; nothing moves to the host but the metrics the caller reads.  The
mesh-only options (a mesh, ``fsdp``, ``local_grads`` with a mesh, the
expert-parallel context) raise ``NotImplementedError``: they belong to the
distribution layer (ROADMAP item 10).
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
from repro_torch.dist import compression
from repro_torch.models import transformer as tr
from repro_torch.optim import zero1
from repro_torch.optim.optimizers import OptConfig, make_optimizer

PROFILE_IDS = 8192      # router ids a step feeds the sketch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    remat: bool = True
    grad_compression: bool = False
    zero1: bool = False
    compress_collective: bool = False  # int8+EF ZeRO-1 delta (DESIGN.md §14)
    fsdp: bool = False                 # ZeRO-3 over 'data' (a mesh)
    local_grads: bool = False          # the DP reduce out of the loop (a mesh)
    offload_master: bool = False       # ZeRO-1 m/v/ef in the slow tier
    profile_experts: bool = True       # NeoMem router-stream profiling
    sketch_width: int = 1 << 14


def _check_single_device(mesh, tcfg: TrainConfig) -> None:
    if mesh is not None or tcfg.fsdp:
        raise NotImplementedError(
            "training over a mesh (fsdp, local_grads, the expert-parallel "
            "context) is not yet ported to repro_torch (ROADMAP item 10, the "
            "distribution layer)")


def prof_params(tcfg: TrainConfig) -> NeoProfParams:
    return NeoProfParams(sketch=SketchParams(width=tcfg.sketch_width))


def init_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig(), params=None,
               *, seed: int = 0, device="cuda"):
    """The train state the reference's step takes: ``params`` (drawn from
    ``seed`` unless given), ``opt`` (the optimizer's state, or ZeRO-1's
    flat vectors), ``prof`` (a NeoProf state whose sketch has the
    reference's seeds) and, with ``grad_compression``, ``ef``."""
    _check_single_device(None, tcfg)
    if params is None:
        params = tr.init_params(cfg, seed, device=device)
    dev = tree_leaves(params)[0].device
    pp = prof_params(tcfg)
    seeds = sk.key_seeds(pp.sketch.depth, pp.sketch.width)
    state = {"params": params, "prof": neoprof_init(pp, seeds, device=dev)}
    if tcfg.zero1:
        state["opt"], _ = zero1.zero1_init(
            params, None, compress_collective=tcfg.compress_collective,
            offload=tcfg.offload_master)
    else:
        state["opt"] = make_optimizer(tcfg.opt)[0](params)
    if tcfg.grad_compression:
        state["ef"] = compression.ef_init(params)
    return state


def to_batch(batch: dict, device) -> dict:
    """A numpy batch (``data.pipeline``'s) as tensors on ``device``."""
    return {k: tensor_from_numpy(np.ascontiguousarray(v), device)
            for k, v in batch.items()}


def build_train_step(cfg: ArchConfig, mesh=None, tcfg: TrainConfig = TrainConfig()):
    """-> ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss``, ``gnorm``, ``lr`` (() float32 tensors on the device) and with
    ZeRO-1 ``collective_bytes``."""
    _check_single_device(mesh, tcfg)
    _, opt_update = make_optimizer(tcfg.opt)
    pp = prof_params(tcfg)
    m = tcfg.microbatches
    spec = None             # ZeRO-1's flat layout: shapes only, built at step 1

    def grads_and_loss(params, batch):
        leaves = tree_leaves(params)
        live_leaves = [p.detach().requires_grad_() for p in leaves]
        live = tree_unflatten(params, live_leaves)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        streams = []
        for i in range(m):
            mb = {k: v[i::m] for k, v in batch.items()}
            loss, (_, aux) = tr.train_loss(cfg, live, mb, remat=tcfg.remat)
            grads = torch.autograd.grad(loss, live_leaves, allow_unused=True)
            with torch.no_grad():
                for a, g in zip(gacc, grads):
                    if g is not None:      # a leaf off the loss's path: zero
                        a.add_(g)
                lsum = lsum + loss.detach()
            del grads, loss
            if "router_streams" in aux:
                streams.append(aux["router_streams"])
        div = torch.tensor(float(m), device=lsum.device)
        for a in gacc:
            a.div_(div)
        return gacc, lsum / div, streams

    def train_step(state, batch):
        nonlocal spec
        params, opt_state, prof = state["params"], state["opt"], state["prof"]
        if tcfg.zero1 and tcfg.offload_master:
            opt_state = zero1.fetch_opt(opt_state)
        gl, loss, streams = grads_and_loss(params, batch)
        if tcfg.profile_experts and cfg.moe is not None and streams:
            page_stream = torch.stack(streams).reshape(-1)[:PROFILE_IDS]
            prof = neoprof_observe(prof, page_stream.to(torch.int32), pp)
        grads = tree_unflatten(params, gl)
        del gl
        new_state = dict(state)
        if tcfg.grad_compression:
            qs, new_state["ef"] = compression.compress_grads(grads, state["ef"])
            grads = compression.decompress_grads(qs)
            del qs
        if tcfg.zero1:
            spec = spec or zero1.flat_spec(params)
            params, opt_state, om = zero1.zero1_update(
                tcfg.opt, params, grads, opt_state, spec,
                compress_collective=tcfg.compress_collective)
            if tcfg.offload_master:
                opt_state = zero1.offload_opt(opt_state)
        else:
            params, opt_state, om = opt_update(params, grads, opt_state)
        new_state.update(params=params, opt=opt_state, prof=prof)
        return new_state, {"loss": loss, **om}

    return train_step
