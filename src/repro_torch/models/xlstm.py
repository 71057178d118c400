"""xLSTM blocks, the serving half: mLSTM (matrix memory) and sLSTM (scalar
memory) parameters and their single-token recurrent decodes (port of
``repro/models/xlstm.py``).

The decode states are O(1) in the sequence length: mLSTM keeps per head
``c`` (B, H, dh, dh), ``n`` (B, H, dh) and the stabiliser ``m`` (B, H);
sLSTM keeps ``c``, ``n`` and ``m`` (B, d).  All are float32, and ``m``
starts at -1e30, so the first step's ``exp(logf + m - m_new)`` is exactly 0
(a lane reset must restore it, not zero it).  The decodes are pure — they
return the new state and the caller commits it (``models/decode.py``, in
place, under the lane mask).  The chunked training forms (``mlstm_apply``,
``slstm_apply``) come with the training forward.

The reference has no Pallas kernel here; this is plain torch, op for op
the reference's: ``log_sigmoid`` is ``jax.nn.log_sigmoid``'s
``-softplus(-x)`` and the mLSTM normaliser ``max(|n . q|, exp(-m))``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import _normal
from repro_torch.models.layers import DTYPE
from repro_torch.models.mamba2 import softplus

M_INIT = -1e30      # the stabiliser's initial value (the reference's -inf stand-in)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def _rms_out(h, p, dtype):
    """The blocks' output norm (float32 RMS, scale ``norm``), back in the
    input's dtype for the output projection ``wo``."""
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6) * p["norm"]
    return h.to(dtype) @ p["wo"]


# -- mLSTM ---------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, d, *, n_heads=4, groups: int = 0,
               device="cuda", dtype=DTYPE):
    """The reference's ``mlstm_init`` tree and scales (gates float32, the
    forget bias 3); ``groups > 0`` stacks that many layers."""
    lead = (groups,) if groups else ()
    s = d ** -0.5
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": _normal(lead + (d, d), s, gen, device, dtype),
        "wk": _normal(lead + (d, d), s, gen, device, dtype),
        "wv": _normal(lead + (d, d), s, gen, device, dtype),
        "wi": _normal(lead + (d, n_heads), s, gen, device, torch.float32),
        "wf": _normal(lead + (d, n_heads), s, gen, device, torch.float32),
        "f_bias": torch.full(lead + (n_heads,), 3.0, **f32),
        "ogate": _normal(lead + (d, d), s, gen, device, dtype),
        "norm": torch.ones(lead + (d,), **f32),
        "wo": _normal(lead + (d, d), s, gen, device, dtype),
    }


def mlstm_init_cache(batch, d, n_heads=4, *, lead=(), device="cuda"):
    dh = d // n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(lead + (batch, n_heads, dh, dh), **f32),
            "n": torch.zeros(lead + (batch, n_heads, dh), **f32),
            "m": torch.full(lead + (batch, n_heads), M_INIT, **f32)}


def mlstm_decode(p, u_t, cache, *, n_heads=4):
    """u_t: (B, 1, D) -> (y_t (B, 1, D), new state {"c", "n", "m"})."""
    bsz, _, d = u_t.shape
    dh = d // n_heads
    q = (u_t @ p["wq"]).reshape(bsz, n_heads, dh).float() * dh ** -0.5
    k = (u_t @ p["wk"]).reshape(bsz, n_heads, dh).float() * dh ** -0.5
    v = (u_t @ p["wv"]).reshape(bsz, n_heads, dh).float()
    u = u_t[:, 0].float()
    logf = log_sigmoid(u @ p["wf"] + p["f_bias"])            # (B, H)
    logi = u @ p["wi"]
    m_new = torch.maximum(cache["m"] + logf, logi)
    sc_old = torch.exp(cache["m"] + logf - m_new)
    sc_in = torch.exp(logi - m_new)
    c = cache["c"] * sc_old[..., None, None] + sc_in[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    n = cache["n"] * sc_old[..., None] + sc_in[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(bsz, 1, d) * torch.sigmoid(u_t @ p["ogate"]).float()
    return _rms_out(h, p, u_t.dtype), {"c": c, "n": n, "m": m_new}


# -- sLSTM ---------------------------------------------------------------------

def slstm_init(gen: torch.Generator, d, *, groups: int = 0, device="cuda",
               dtype=DTYPE):
    """The reference's ``slstm_init`` tree and scales (``wi``/``wf`` and
    the gates' bias float32; the reference's ``n_heads`` is unused)."""
    lead = (groups,) if groups else ()
    s = d ** -0.5
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": _normal(lead + (d, d), s, gen, device, dtype),
        "wi": _normal(lead + (d, d), s, gen, device, torch.float32),
        "wf": _normal(lead + (d, d), s, gen, device, torch.float32),
        "wo_gate": _normal(lead + (d, d), s, gen, device, dtype),
        "f_bias": torch.full(lead + (d,), 3.0, **f32),
        "norm": torch.ones(lead + (d,), **f32),
        "wo": _normal(lead + (d, d), s, gen, device, dtype),
    }


def slstm_init_cache(batch, d, *, lead=(), device="cuda"):
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(lead + (batch, d), **f32),
            "n": torch.zeros(lead + (batch, d), **f32),
            "m": torch.full(lead + (batch, d), M_INIT, **f32)}


def slstm_decode(p, u_t, cache):
    """u_t: (B, 1, D) -> (y_t (B, 1, D), new state {"c", "n", "m"})."""
    x = u_t[:, 0]
    u = x.float()
    z = torch.tanh((x @ p["wz"]).float())
    logi = u @ p["wi"]
    logf = log_sigmoid(u @ p["wf"] + p["f_bias"])
    o = torch.sigmoid(x @ p["wo_gate"]).float()
    m_new = torch.maximum(logf + cache["m"], logi)
    keep = torch.exp(logf + cache["m"] - m_new)
    take = torch.exp(logi - m_new)
    c = keep * cache["c"] + take * z
    n = keep * cache["n"] + take
    h = o * (c / torch.clamp_min(n, 1.0))
    return _rms_out(h[:, None, :], p, u_t.dtype), {"c": c, "n": n, "m": m_new}
