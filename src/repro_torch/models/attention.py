"""GQA attention parameters and projections (port of ``repro/models/attention.py``,
the parts the paged decode path reads)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import DTYPE


def _normal(shape, std, generator, device, dtype):
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)


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
