"""Embedding-row tiering on the PyTorch port (the twin of
``examples/profile_embeddings.py``): a gemma2-scale 256K-row vocabulary, a
zipf token stream; NeoMem keeps the hot rows' pages in fast memory.  The
sketch takes the reference's H3 seeds, so every printed line equals the
reference example's.

    PYTHONPATH=src python examples/profile_embeddings_torch.py             # on the card
    PYTHONPATH=src python examples/profile_embeddings_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import tiering as tm
from repro_torch.core.sketch import key_seeds

VOCAB = 256_000
ROWS = tm.EMBED_ROWS_PER_PAGE
STEPS = 96


def main(device: str = "cuda") -> dict:
    """Run the stream on ``device``; returns the printed records (step, hit
    rate, θ) and the resource's integers (as ``quickstart_torch.integers``)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    daemon = tm.NeoMemDaemon(device=device)
    spec = tm.ResourceSpec("embeddings", n_pages=(VOCAB + ROWS - 1) // ROWS,
                           hot_slots=256, quota_pages=64)
    rows = daemon.register(tm.make_resource("embeddings", spec),
                           seeds=key_seeds(spec.sketch_depth, spec.sketch_width))
    rng = np.random.default_rng(0)
    records = []
    for step in range(STEPS):
        toks = (rng.zipf(1.3, 4096) - 1) % VOCAB
        rows.observe(torch.from_numpy(toks.astype(np.int32)).to(device))
        daemon.tick()
        if step % 16 == 15:
            theta = rows.stats.theta_trace[-1] if rows.stats.theta_trace else 1
            rec = dict(step=step, hit=rows.hit_rate(), theta=theta)
            records.append(rec)
            print(f"step {step:3d} hot-row page hit rate: {rec['hit']:.3f} "
                  f"theta={theta}")
    row = rows.snapshot()
    return dict(records=records,
                page_slot=rows.state.tier.page_slot.cpu().numpy(),
                slot_page=rows.state.tier.slot_page.cpu().numpy(),
                theta_trace=list(rows.stats.theta_trace),
                counters={k: row[k] for k in ("fast_reads", "slow_reads",
                                              "promoted", "demoted", "ping_pong")})


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
