"""Parameter init for the dense decoder (port of ``repro/models/transformer.py``
``init_params``, dense family only).

Layers are stacked by *pattern group*: ``params["blocks"][i]`` holds pattern
position i with every leaf shaped ``(G, ...)``, the reference's layout, so
weights converted from the reference (:mod:`repro_torch.convert`) drop in.
Weights are drawn on the target device from a seeded ``torch.Generator``
with the reference's init scales; the numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import _normal, gqa_init
from repro_torch.models.layers import DTYPE


def _norm(shape, device):
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def check_dense(cfg: ArchConfig) -> None:
    """The port runs the dense GQA family only; raise for anything else."""
    if (cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None
            or set(cfg.pattern) != {"attn"} or cfg.mlp != "swiglu"
            or cfg.norm != "rms" or cfg.post_norm or cfg.embed_scale):
        raise NotImplementedError(
            f"arch {cfg.name!r} ({cfg.family}, pattern {cfg.pattern}) is not yet "
            "ported to repro_torch: only the dense GQA family with RMS norms is")


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda"):
    check_dense(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, g, f = cfg.d_model, cfg.n_groups, cfg.d_ff
    blocks = []
    for _ in cfg.pattern:
        blocks.append({
            "ln1": _norm((g, d), device),
            "ln2": _norm((g, d), device),
            "attn": gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             groups=g, bias=cfg.qkv_bias, dtype=DTYPE,
                             device=device),
            "ffn": {
                "w_in": _normal((g, d, f), d ** -0.5, gen, device, DTYPE),
                "w_gate": _normal((g, d, f), d ** -0.5, gen, device, DTYPE),
                "w_out": _normal((g, f, d), f ** -0.5, gen, device, DTYPE),
            },
        })
    return {
        "embed": {"table": _normal((cfg.vocab, d), d ** -0.5, gen, device, DTYPE)},
        "blocks": blocks,
        "final_norm": _norm((d,), device),
    }
