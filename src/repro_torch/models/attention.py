"""GQA attention parameters and projections (port of ``repro/models/attention.py``,
the parts the paged decode path reads)."""
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
