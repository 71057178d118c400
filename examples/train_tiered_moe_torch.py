"""End-to-end driver on the PyTorch port (the twin of
``examples/train_tiered_moe.py``): train a ~100M-param MoE LM for a few
hundred steps with NeoMem expert-stream profiling, checkpointing and crash
resume.  The step is the port's ``train_loss`` under autograd and
``make_optimizer``'s AdamW; the router stream feeds an ``"experts"``
resource; checkpoints go through ``repro_torch.ckpt.manager`` in the
reference's layout.  The default checkpoint directory is not the
reference's, so a run never resumes a JAX run by accident.

    PYTHONPATH=src python examples/train_tiered_moe_torch.py --steps 200
    PYTHONPATH=src python examples/train_tiered_moe_torch.py --device cpu \\
        --steps 2 --batch 2 --seq 32
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import tiering as tm
from repro_torch.ckpt.manager import CheckpointManager, tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.core.sketch import key_seeds
from repro_torch.data.pipeline import DataConfig, make_dataset
from repro_torch.models import transformer as tr
from repro_torch.optim.optimizers import OptConfig, make_optimizer
from repro_torch.train.step import to_batch

# ~100M params: 8L, d=512, 16 experts of ff=1024 top-2, vocab 32K
CFG = ArchConfig(
    name="moe-100m", family="moe", n_layers=9, d_model=512, n_heads=8,
    n_kv_heads=4, d_ff=2048, vocab=32000, head_dim=64, pattern=("moe",),
    moe=MoECfg(n_experts=16, top_k=2, expert_ff=1024, shared_ff=1024,
               n_dense_prologue=1, dense_ff=2048),
)
CKPT = os.path.join(tempfile.gettempdir(), "neomem_moe_ckpt_torch")


def tiered_experts(device):
    """The multiplexed daemon with the router stream's ``"experts"``
    resource (a trainer would register more resources here) -> (daemon,
    handle)."""
    daemon = tm.NeoMemDaemon(device=device)
    spec = tm.ResourceSpec("experts", n_pages=CFG.n_groups * 16,
                           hot_slots=CFG.n_groups * 4, quota_pages=32)
    experts = daemon.register(tm.make_resource("experts", spec, n_experts=16),
                              seeds=key_seeds(spec.sketch_depth, spec.sketch_width))
    return daemon, experts


def main(steps: int = 200, batch: int = 8, seq: int = 256, ckpt: str = CKPT,
         device: str = "cuda", params=None, on_step=None) -> dict:
    """Train on ``device``; ``params`` default to the port's draw from seed
    0, ``on_step(s, params, loss, router_streams, experts)`` is called after
    each step (and its daemon tick).  Returns the per-step losses, the printed records, the step the
    run resumed from, the final params, the experts' residency per group and
    the experts handle."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    n = CFG.total_params()
    print(f"model: {n/1e6:.0f}M params ({CFG.active_params()/1e6:.0f}M active)")
    data = make_dataset(DataConfig(seq_len=seq, global_batch=batch,
                                   vocab=CFG.vocab))
    opt_init, opt_update = make_optimizer(OptConfig(
        lr=1e-3, warmup_steps=20, total_steps=steps, weight_decay=0.01))
    if params is None:
        params = tr.init_params(CFG, seed=0, device=device)
    opt_state = opt_init(params)
    mgr = CheckpointManager(ckpt, keep=2)
    daemon, experts = tiered_experts(device)

    start = mgr.latest_step() or 0
    if start:
        print(f"resuming from checkpoint step {start}")
        params = mgr.restore(start, params)

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss, (_, aux) = tr.train_loss(CFG, tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        params, opt_state, _ = opt_update(params, tree_unflatten(params, grads),
                                          opt_state)
        return params, opt_state, loss.detach(), aux.get("router_streams")

    where = (torch.cuda.get_device_name(device)
             if torch.device(device).type == "cuda" else "the CPU")
    losses, records = [], []
    t0 = time.time()
    for s in range(start, steps):
        params, opt_state, loss, streams = step(
            params, opt_state, to_batch(data.batch(s, 0, 1), device))
        if streams is not None:
            experts.observe(streams)      # NeoMem: profile the router stream
            daemon.tick()
        losses.append(float(loss))
        if on_step is not None:
            on_step(s, params, loss, streams, experts)
        if s % 20 == 0 or s == steps - 1:
            tput = (s - start + 1) * batch * seq / (time.time() - t0)
            rec = dict(step=s, loss=losses[-1], tok_s=tput,
                       expert_hit=experts.hit_rate())
            records.append(rec)
            print(f"step {s:4d} loss={rec['loss']:.3f} tok/s={tput:,.0f} on "
                  f"{where} expert_hit={rec['expert_hit']:.2f}")
        if s and s % 100 == 0:
            mgr.save(s, params, blocking=False)
    mgr.wait()
    mgr.save(steps, params)
    print("final expert residency (hot experts per group):")
    res = (experts.state.tier.page_slot.cpu().numpy()
           .reshape(CFG.n_groups, 16) >= 0).sum(axis=1)
    print(res)
    return dict(losses=losses, records=records, start=start, params=params,
                residency=res, experts=experts)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, args.batch, args.seq, args.ckpt, args.device)
