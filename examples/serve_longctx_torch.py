"""Serve a small LM with NeoMem tiering on the PyTorch port (the twin of
``examples/serve_longctx.py``): paged-KV decode over fast-tier hot pages
plus embedding-row tiering, both multiplexed on ONE daemon with a shared
migration budget.  The model is the reference's llama3.2-3b smoke config;
the weights are drawn from seed 0 unless ``main`` is handed a params tree,
and every resource's sketch takes the reference's H3 seeds.

    PYTHONPATH=src python examples/serve_longctx_torch.py              # on the card
    PYTHONPATH=src python examples/serve_longctx_torch.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.sketch import key_seeds
from repro_torch.models import transformer as tr
from repro_torch.serve.engine import ServeConfig, ServeEngine

SCFG = dict(max_seq=512, paged=True, page_t=16, hot_slots=8,
            migration_interval=8, resources=("embeddings",), embed_hot_slots=4)
BATCH, PROMPT, NEW = 4, 48, 32


def main(device: str = "cuda", params=None, on_engine=None) -> dict:
    """Serve the batch on ``device``; ``params`` default to the port's draw
    from seed 0, ``on_engine(eng)`` is called before the first token.
    Returns the tokens, the tier rows, and the wall seconds."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    cfg = get_smoke_config("llama3.2-3b")
    if params is None:
        params = tr.init_params(cfg, seed=0, device=device)
    eng = ServeEngine(cfg, params, ServeConfig(**SCFG), device=device,
                      sketch_seeds=key_seeds(2, 1 << 14))
    if on_engine is not None:
        on_engine(eng)

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    print(f"prefill {BATCH} requests x {prompts.shape[1]} tokens (paged KV,"
          f" {eng.scfg.hot_slots} hot slots x {eng.scfg.page_t} tokens; "
          f"tiered resources: {sorted(eng.daemon.resources)})")
    t0 = time.time()
    out = eng.generate(prompts, n_tokens=NEW)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
             else "the CPU")
    print(f"generated {out.shape} in {dt:.1f}s "
          f"({BATCH * NEW / dt:.1f} tok/s on {where})")
    rows = eng.tier_stats()
    for name, row in sorted(rows.items()):
        print(f"{name:12s} fast-tier hit rate: {row['hit_rate']:.2f}")
    print("sample:", out[0][:16])
    return dict(tokens=out, tier_stats=rows, seconds=dt, engine=eng)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
