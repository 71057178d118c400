"""Shared model building blocks: norms, rotary embeddings, MLPs, embeddings
and the training loss's cross entropy.

Port of ``repro/models/layers.py``: params are bf16 by default with fp32
norm scales, softmax/rotary math is fp32, and weights keep the reference
layout ``x @ W`` with W ``(d_in, d_out)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPE = torch.bfloat16


def rmsnorm(p, x, eps=1e-6, plus_one: bool = False):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p["scale"] + 1.0 if plus_one else p["scale"]
    return (y * scale).to(x.dtype)


def layernorm(p, x, eps=1e-5):
    """LayerNorm over the last axis with the population variance, as
    ``jnp.var`` takes it (``torch.var`` would divide by n - 1)."""
    xf = x.float()
    c = xf - xf.mean(dim=-1, keepdim=True)
    var = (c * c).mean(dim=-1, keepdim=True)
    return (c * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def make_norm(kind: str, shape, device) -> dict:
    """A norm's float32 params of ``shape`` (the width, behind any stacking
    axes): "rms" a scale of ones, "rms+1" (gemma: applied as 1 + w) a scale
    of zeros, "ln" a scale of ones and a bias of zeros."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "rms":
        return {"scale": torch.ones(shape, **f32)}
    if kind == "rms+1":
        return {"scale": torch.zeros(shape, **f32)}
    return {"scale": torch.ones(shape, **f32), "bias": torch.zeros(shape, **f32)}


def apply_norm(kind: str, p, x):
    if kind == "rms":
        return rmsnorm(p, x)
    if kind == "rms+1":
        return rmsnorm(p, x, plus_one=True)
    return layernorm(p, x)


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
    """swiglu and geglu (tanh-approximate GELU, as ``jax.nn.gelu(...,
    approximate=True)``) gate ``w_in``'s product with ``w_gate``'s; "gelu"
    is the biased two-matrix MLP."""
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
        return h @ p["w_out"]
    if kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_in"])
        return h @ p["w_out"]
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    return h @ p["w_out"] + p["b_out"]


def embed_apply(p, tokens):
    return p["table"][tokens]


def logits_apply(p, x, softcap: float = 0.0):
    logits = (x @ p["table"].T).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean token NLL, ``logsumexp - gold``; with a ``loss_mask`` the sum
    over the masked tokens divided by max(their count, 1)."""
    nll = torch.logsumexp(logits, dim=-1) - torch.take_along_dim(
        logits, labels.long()[..., None], dim=-1)[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
