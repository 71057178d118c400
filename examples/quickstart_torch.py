"""Quickstart on the PyTorch port: NeoMem's sketch-profiled tiering on a
synthetic access stream (the twin of ``examples/quickstart.py``).

One :class:`ResourceSpec` declares the geometry, NeoProf observes the
stream on the device, Algorithm 1 adapts the hotness threshold, the 2Q tier
promotes hot pages under quota, and the hit rate converges.  The sketch
takes the reference's H3 seeds (``key_seeds``), so every printed line
equals the reference example's.

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.sketch import key_seeds
from repro_torch.tiering import (DaemonParams, NeoMemDaemon, ResourceSpec,
                                 StreamResource)

N_PAGES, N_SLOTS = 8192, 1024
STEPS = 128


def main(device: str = "cuda") -> dict:
    """Run the loop on ``device``; returns the printed records (step, θ,
    hit rate, promotions), the hot pages resident at the end, and the
    resource's integers (placement tables, θ trace, drained counters)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    spec = ResourceSpec(name="demo", n_pages=N_PAGES, hot_slots=N_SLOTS,
                        quota_pages=128, sketch_width=1 << 14)
    daemon = NeoMemDaemon(DaemonParams(
        migration_interval=1, threshold_update_period=4, clear_interval=16),
        device=device)
    h = daemon.register(StreamResource(spec),
                        seeds=key_seeds(spec.sketch_depth, spec.sketch_width))
    h.state = h.state._replace(prof=h.mem.cmd.set_threshold(h.state.prof, 4))

    rng = np.random.default_rng(0)
    records = []
    for step in range(STEPS):
        # 85% of traffic to a 600-page hot region, 15% uniform
        hot = rng.integers(7000, 7600, 1740)
        uni = rng.integers(0, N_PAGES, 308)
        pages = np.concatenate([hot, uni]).astype(np.int32)
        # profile ONLY slow-tier traffic (NeoProf sits in the slow tier);
        # the tier's touch accounting still sees every access
        slot = h.state.tier.page_slot.cpu().numpy()
        slow = pages[slot[pages] < 0]
        blk = np.full(len(pages), -1, np.int32)
        blk[: len(slow)] = slow
        h.observe_pages(torch.from_numpy(blk).to(device),
                        touch_pages=torch.from_numpy(pages).to(device))
        daemon.tick()
        if step % 16 == 15:
            pol = h.mem.policy_state(h.state, h.stats)
            rec = dict(step=step, theta=pol.theta, hit=h.hit_rate(),
                       promoted=h.stats.promoted)
            records.append(rec)
            print(f"step {step:4d}  theta={pol.theta:4d}  "
                  f"hit={rec['hit']:.3f}  promoted={rec['promoted']}")
    resident = int((h.state.tier.page_slot[7000:7600] >= 0).sum())
    print("hot pages resident:", resident, "/ 600")
    return dict(records=records, resident=resident, **integers(h))


def integers(h) -> dict:
    """A resource handle's integers: placement tables, θ trace, drained and
    undrained hit counters, promotions, demotions, ping-pongs."""
    row = h.snapshot()
    return dict(page_slot=h.state.tier.page_slot.cpu().numpy(),
                slot_page=h.state.tier.slot_page.cpu().numpy(),
                theta_trace=list(h.stats.theta_trace),
                counters={k: row[k] for k in ("fast_reads", "slow_reads",
                                              "promoted", "demoted", "ping_pong")})


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
