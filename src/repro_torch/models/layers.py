"""Shared model building blocks: norms, rotary embeddings, MLPs, embeddings
and the training loss's cross entropy.

Port of ``repro/models/layers.py``: params are bf16 by default with fp32
norm scales, softmax/rotary math is fp32, and weights keep the reference
layout ``x @ W`` with W ``(d_in, d_out)``.

The MLP, the embedding, the head and the loss take a ``part`` (a
:class:`repro_torch.dist.collectives.Part` of 'model') where their weights
are the rank's blocks, as the reference's partitioner computes them:
``w_gate``/``w_in`` column-parallel and ``w_out`` row-parallel (the parts
summed, a row bias added once after), the embedding over the rank's vocab
rows (other ids look up zeros, then the parts summed), the head over its
vocab columns (each block softcapped) and the loss vocab-parallel (the max
over ranks without a gradient, the exps summed over ranks, the gold logit
from the block that holds it).  With one rank in the part each is today's
arithmetic, op for op.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col

DTYPE = torch.bfloat16

_WHOLE_DRAW = 1 << 30     # elements above which a tensor is drawn in slices
_DRAW_SLICE = 1 << 28     # float32 elements drawn at once in that case


def _normal(shape, std, generator, device, dtype):
    """N(0, std^2) weights in ``dtype``, drawn in float32 from ``generator``.
    A tensor of more than 2^30 elements (kimi-k2's expert stacks, 5.6 G
    elements each) is filled 2^28 elements at a time, scaled in place, so
    the float32 temporaries stay at 1 GiB instead of twice the tensor.  On
    the meta device: the shape alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    n = math.prod(shape)
    if n <= _WHOLE_DRAW:
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for lo in range(0, n, _DRAW_SLICE):
        part = torch.randn((min(_DRAW_SLICE, n - lo),), generator=generator,
                           device=device, dtype=torch.float32)
        flat[lo:lo + part.numel()].copy_(part.mul_(std))
    return out


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

def mlp_init(gen: torch.Generator, d: int, f: int, kind: str = "swiglu", *,
             lead: tuple = (), device="cuda", dtype=DTYPE) -> dict:
    """An MLP's weights with the reference's init scales, drawn from ``gen``
    (``w_in``, then ``w_gate``, then ``w_out``): swiglu and geglu gate
    ``w_in`` (d, f) with ``w_gate`` (d, f), std d^-1/2, before ``w_out``
    (f, d), std f^-1/2; "gelu" has ``w_in`` and ``w_out`` with zero biases
    ``b_in`` (f,) and ``b_out`` (d,).  ``lead`` stacks layers on leading
    axes."""
    if kind == "gelu":
        return {"w_in": _normal(lead + (d, f), d ** -0.5, gen, device, dtype),
                "b_in": torch.zeros(lead + (f,), dtype=dtype, device=device),
                "w_out": _normal(lead + (f, d), f ** -0.5, gen, device, dtype),
                "b_out": torch.zeros(lead + (d,), dtype=dtype, device=device)}
    return {"w_in": _normal(lead + (d, f), d ** -0.5, gen, device, dtype),
            "w_gate": _normal(lead + (d, f), d ** -0.5, gen, device, dtype),
            "w_out": _normal(lead + (f, d), f ** -0.5, gen, device, dtype)}


def mlp_apply(p, x, kind: str = "swiglu", part=None):
    """swiglu and geglu (tanh-approximate GELU, as ``jax.nn.gelu(...,
    approximate=True)``) gate ``w_in``'s product with ``w_gate``'s; "gelu"
    is the biased two-matrix MLP.  With ``part`` the weights are the
    rank's column and row blocks (the module docstring)."""
    if part is not None:
        x = col.enter(x, part.group)
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_in"])
    else:
        h = F.gelu(x @ p["w_in"] + _col_bias(p["b_in"], part), approximate="tanh")
    y = h @ p["w_out"]
    if part is not None:
        y = col.sum_parts(y, part.group)
    return y + p["b_out"] if kind == "gelu" else y


def _col_bias(b, part):
    """A replicated bias of a column-parallel product: the rank's block,
    entering the region (its gradient summed over the ranks' blocks)."""
    return b if part is None else part.block(col.enter(b, part.group), -1)


def embed_init(gen: torch.Generator, v: int, d: int, *, device="cuda",
               dtype=DTYPE) -> dict:
    """The (v, d) embedding table (tied to the head), std d^-1/2."""
    return {"table": _normal((v, d), d ** -0.5, gen, device, dtype)}


def embed_apply(p, tokens, part=None):
    """The table's rows of ``tokens``; with ``part`` the table is the rank's
    vocab rows, ids outside them look up zeros and the parts are summed."""
    if part is None:
        return p["table"][tokens]
    table = p["table"]
    rows = table.shape[0]
    local = tokens - part.rank * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return col.sum_parts(x, part.group)


def logits_apply(p, x, softcap: float = 0.0, part=None):
    """The tied head's float32 logits, softcapped; with ``part`` the rank's
    vocab columns of them (:func:`gather_logits` makes them whole)."""
    if part is not None:
        x = col.enter(x, part.group)
    logits = (x @ p["table"].T).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def gather_logits(logits, part):
    """A head's vocab-parallel logits made whole over the part's ranks (no
    gradient: decode and sampling read them)."""
    if part is None:
        return logits
    return col.all_gather(logits.detach(), logits.dim() - 1, part.group)


class _VocabLSE(torch.autograd.Function):
    """log-sum-exp over a vocab split over ``group``, as
    ``torch.logsumexp`` computes it (the max shift, masked where infinite;
    the exps summed; log, plus the shift), the row max and the sum taken
    over the ranks; backward ``torch.logsumexp``'s rule, g * exp(x - lse),
    on the rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        m = col.max_over(torch.amax(x, dim=-1, keepdim=True), group)
        shift = m.squeeze(-1)
        shift.masked_fill_(shift.abs() == torch.inf, 0)
        s = col.all_reduce((x - m).exp_().sum(dim=-1), group)
        lse = s.log_().add_(shift)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp(), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None, part=None) -> torch.Tensor:
    """Mean token NLL, ``logsumexp - gold``; with a ``loss_mask`` the sum
    over the masked tokens divided by max(their count, 1).  With ``part``
    the logits are the rank's vocab columns (the module docstring)."""
    if part is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    else:
        lse = _VocabLSE.apply(logits, part.group)
        cols = logits.shape[-1]
        local = labels.long() - part.rank * cols
        inside = (local >= 0) & (local < cols)
        gold = torch.take_along_dim(logits, local.clamp(0, cols - 1)[..., None],
                                    dim=-1)[..., 0]
        gold = col.sum_parts(torch.where(inside, gold, 0.0), part.group)
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
