"""Parameter init for the decoder families the port serves (port of
``repro/models/transformer.py`` ``init_params``): the dense GQA family and
the GQA mixture-of-experts family (kimi-k2).

Layers are stacked by *pattern group*: ``params["blocks"][i]`` holds pattern
position i with every leaf shaped ``(G, ...)``, the reference's layout, so
weights converted from the reference (:mod:`repro_torch.convert`) drop in.
A MoE arch's dense prologue layers are ``params["prologue"]``, a list of
unstacked blocks whose FFN is ``dense_ff`` wide.  Weights are drawn on the
target device from a seeded ``torch.Generator`` with the reference's init
scales; the numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import _normal, gqa_init
from repro_torch.models.layers import DTYPE
from repro_torch.models.moe import moe_init


def _norm(shape, device):
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def check_ported(cfg: ArchConfig) -> None:
    """The port runs GQA attention with RMS norms and swiglu, in the dense
    family (pattern ``("attn",)``) or the MoE family (pattern ``("moe",)``
    behind dense prologue layers); raise for anything else (MLA, the
    multi-token head, SSM, local/global windows, the other families)."""
    dense = cfg.family == "dense" and cfg.moe is None \
        and set(cfg.pattern) == {"attn"}
    moe = cfg.family == "moe" and cfg.moe is not None \
        and set(cfg.pattern) == {"moe"}
    if (not (dense or moe) or cfg.mla is not None or cfg.mtp
            or cfg.mlp != "swiglu" or cfg.norm != "rms" or cfg.post_norm
            or cfg.embed_scale):
        raise NotImplementedError(
            f"arch {cfg.name!r} ({cfg.family}, pattern {cfg.pattern}) is not yet "
            "ported to repro_torch: only the dense and MoE GQA families with "
            "RMS norms are")


def _mlp(gen, d, f, lead, device):
    return {"w_in": _normal(lead + (d, f), d ** -0.5, gen, device, DTYPE),
            "w_gate": _normal(lead + (d, f), d ** -0.5, gen, device, DTYPE),
            "w_out": _normal(lead + (f, d), f ** -0.5, gen, device, DTYPE)}


def _block(gen, cfg: ArchConfig, kind: str, groups: int, device):
    """One block of ``kind`` ("attn", "moe", or "attn_dense" for a MoE
    arch's prologue); ``groups > 0`` stacks that many on a leading axis."""
    d = cfg.d_model
    lead = (groups,) if groups else ()
    p = {"ln1": _norm(lead + (d,), device), "ln2": _norm(lead + (d,), device),
         "attn": gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          groups=groups, bias=cfg.qkv_bias, dtype=DTYPE,
                          device=device)}
    if kind == "moe":
        mc = cfg.moe
        p["ffn"] = moe_init(gen, d, mc.n_experts, mc.expert_ff,
                            shared_f=mc.shared_ff, groups=groups, device=device)
        if mc.bias_free_balance:
            p["router_bias"] = torch.zeros(lead + (mc.n_experts,),
                                           dtype=torch.float32, device=device)
    else:
        width = cfg.moe.dense_ff if kind == "attn_dense" else cfg.d_ff
        p["ffn"] = _mlp(gen, d, width, lead, device)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda"):
    check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    # draw order: the body, the prologue, then the embedding
    params = {"blocks": [_block(gen, cfg, kind, cfg.n_groups, device)
                         for kind in cfg.pattern]}
    if cfg.moe and cfg.moe.n_dense_prologue:
        params["prologue"] = [_block(gen, cfg, "attn_dense", 0, device)
                              for _ in range(cfg.moe.n_dense_prologue)]
    params["embed"] = {"table": _normal((cfg.vocab, cfg.d_model),
                                        cfg.d_model ** -0.5, gen, device, DTYPE)}
    params["final_norm"] = _norm((cfg.d_model,), device)
    return params
