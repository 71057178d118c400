"""Shared model building blocks: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro/models/layers.py``: params are bf16 by default with fp32
norm scales, softmax/rotary math is fp32, and weights keep the reference
layout ``x @ W`` with W ``(d_in, d_out)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPE = torch.bfloat16


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def apply_norm(kind: str, p, x):
    if kind != "rms":
        raise NotImplementedError(f"norm {kind!r} is not yet ported to repro_torch")
    return rmsnorm(p, x)


# -- rotary -----------------------------------------------------------------

def rope_freqs(dh: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Half-split rotary: x (..., S, H, dh); positions broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[..., None].float() * freqs              # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP / embedding / logits -------------------------------------------------

def mlp_apply(p, x, kind: str = "swiglu"):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} is not yet ported to repro_torch")
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    return h @ p["w_out"]


def embed_apply(p, tokens):
    return p["table"][tokens]


def logits_apply(p, x, softcap: float = 0.0):
    logits = (x @ p["table"].T).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
