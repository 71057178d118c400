"""GQA and MLA attention parameters and projections (port of
``repro/models/attention.py``, the parts the paged decode path reads).

MLA's training and dense-cache forms (``mla_apply``, ``mla_decode``) come
with the training forward and the dense cache; serving reads MLA through
the absorbed latent query of the paged decode (``models/decode.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import DTYPE

_WHOLE_DRAW = 1 << 30     # elements above which a tensor is drawn in slices
_DRAW_SLICE = 1 << 28     # float32 elements drawn at once in that case


def _normal(shape, std, generator, device, dtype):
    """N(0, std^2) weights in ``dtype``, drawn in float32 from ``generator``.
    A tensor of more than 2^30 elements (kimi-k2's expert stacks, 5.6 G
    elements each) is filled 2^28 elements at a time, scaled in place, so
    the float32 temporaries stay at 1 GiB instead of twice the tensor."""
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


def gqa_init(generator: torch.Generator, d, h, hkv, dh, *, groups: int = 0,
             bias=False, dtype=DTYPE, device="cuda"):
    """GQA weights with the reference's init scales; ``groups > 0`` stacks
    ``groups`` layers on a leading axis, as the reference's per-group vmap."""
    lead = (groups,) if groups else ()
    s = d ** -0.5
    p = {
        "wq": _normal(lead + (d, h * dh), s, generator, device, dtype),
        "wk": _normal(lead + (d, hkv * dh), s, generator, device, dtype),
        "wv": _normal(lead + (d, hkv * dh), s, generator, device, dtype),
        "wo": _normal(lead + (h * dh, d), (h * dh) ** -0.5, generator, device,
                      dtype),
    }
    if bias:
        for name, width in (("bq", h * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=device)
    return p


def _proj_qkv(p, x, h, hkv, dh):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, h, dh), k.reshape(b, s, hkv, dh),
            v.reshape(b, s, hkv, dh))


# -- DeepSeek-V3 MLA -----------------------------------------------------------

MLA_DEFAULTS = dict(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128)


def mla_init(generator: torch.Generator, d, h, *, groups: int = 0, dtype=DTYPE,
             device="cuda", **dims):
    """MLA weights with the reference's init scales: the low-rank query
    (``wq_a`` -> ``q_norm`` -> ``wq_b``), the latent kv projection with its
    rope key (``wkv_a``, ``kv_norm``), the latent's up-projection ``wkv_b``
    ((kv_lora, h*(d_nope+d_v)): per head the nope key, then the value) and
    ``wo``.  ``dims`` override :data:`MLA_DEFAULTS` (q_lora, kv_lora,
    d_nope, d_rope, d_v); ``groups > 0`` stacks that many layers on a
    leading axis."""
    dims = dict(MLA_DEFAULTS, **dims)
    q_lora, kv_lora, d_v = dims["q_lora"], dims["kv_lora"], dims["d_v"]
    d_nope, d_rope = dims["d_nope"], dims["d_rope"]
    lead = (groups,) if groups else ()
    s = d ** -0.5
    ones = dict(dtype=torch.float32, device=device)
    return {
        "wq_a": _normal(lead + (d, q_lora), s, generator, device, dtype),
        "q_norm": torch.ones(lead + (q_lora,), **ones),
        "wq_b": _normal(lead + (q_lora, h * (d_nope + d_rope)), q_lora ** -0.5,
                        generator, device, dtype),
        "wkv_a": _normal(lead + (d, kv_lora + d_rope), s, generator, device, dtype),
        "kv_norm": torch.ones(lead + (kv_lora,), **ones),
        "wkv_b": _normal(lead + (kv_lora, h * (d_nope + d_v)), kv_lora ** -0.5,
                         generator, device, dtype),
        "wo": _normal(lead + (h * d_v, d), (h * d_v) ** -0.5, generator, device,
                      dtype),
    }


def _rms(x, w, eps=1e-6):
    """RMS norm in float32 with a float32 scale, rounded back to ``x``'s
    dtype (the reference's MLA-internal norm)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)
