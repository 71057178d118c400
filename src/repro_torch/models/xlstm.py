"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) parameters,
their training forms and their single-token recurrent decodes (port of
``repro/models/xlstm.py``).

The decode states are O(1) in the sequence length: mLSTM keeps per head
``c`` (B, H, dh, dh), ``n`` (B, H, dh) and the stabiliser ``m`` (B, H);
sLSTM keeps ``c``, ``n`` and ``m`` (B, d).  All are float32, and ``m``
starts at -1e30, so the first step's ``exp(logf + m - m_new)`` is exactly 0
(a lane reset must restore it, not zero it).  The decodes are pure — they
return the new state and the caller commits it (``models/decode.py``, in
place, under the lane mask).  The training forms: :func:`mlstm_apply`,
chunkwise-parallel (an attention-like term inside each chunk, the
stabilised (C, n, m) state carried across chunks), and :func:`slstm_apply`,
the stabiliser's max-plus recurrence and the linear (c, n) recurrence each
as a log-depth (Hillis-Steele) scan over the sequence, the reference's
``associative_scan`` combine functions.  Their float32 sums run in other
orders than XLA's, so they agree with the reference to rounding.

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


def mlstm_apply(p, u, *, n_heads=4, chunk=128):
    """Chunkwise-parallel mLSTM, u (B, S, D) -> (B, S, D).  The intra-chunk
    weights are masked to -1e30 BEFORE the ``exp`` (the discarded entries
    overflow and would make the gradients NaN)."""
    bsz, s, d = u.shape
    dh = d // n_heads
    uf = u.float()
    q = (u @ p["wq"]).reshape(bsz, s, n_heads, dh).float() * dh ** -0.5
    k = (u @ p["wk"]).reshape(bsz, s, n_heads, dh).float() * dh ** -0.5
    v = (u @ p["wv"]).reshape(bsz, s, n_heads, dh).float()
    logf = log_sigmoid(uf @ p["wf"] + p["f_bias"])            # (B, S, H)
    logi = uf @ p["wi"]

    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    shp = (bsz, nc, chunk, n_heads)
    qf, kf, vf = (t.reshape(*shp, dh) for t in (q, k, v))
    lf, li = logf.reshape(shp), logi.reshape(shp)

    cum_f = torch.cumsum(lf, dim=2)                           # (B, NC, Q, H)
    m_c = (li - cum_f).amax(dim=2, keepdim=True)              # per-chunk stabiliser
    dec = cum_f[:, :, :, None, :] - cum_f[:, :, None, :, :] + li[:, :, None, :, :]
    qi = torch.arange(chunk, device=u.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    w_int = torch.exp(torch.where(causal, dec - m_c[:, :, :, None, :], -1e30))
    scores = torch.einsum("bnqhd,bnthd->bnqth", qf, kf)
    num_intra = torch.einsum("bnqth,bnthd->bnqhd", scores * w_int, vf)
    den_intra = torch.einsum("bnqth,bnthd->bnqhd", w_int, kf)

    to_end = torch.exp(cum_f[:, :, -1:, :] - cum_f + li - m_c)   # (B, NC, Q, H)
    c_state = torch.einsum("bnthd,bnthe->bnhde", to_end[..., None] * kf, vf)
    n_state = torch.einsum("bnth,bnthd->bnhd", to_end, kf)
    g_chunk = cum_f[:, :, -1, :]                              # (B, NC, H)
    m_chunk = m_c[:, :, 0, :]

    f32 = dict(dtype=torch.float32, device=u.device)
    c_prev = torch.zeros((bsz, n_heads, dh, dh), **f32)
    n_prev = torch.zeros((bsz, n_heads, dh), **f32)
    m_prev = torch.full((bsz, n_heads), M_INIT, **f32)
    cs, ns, ms = [], [], []                                   # state BEFORE chunk n
    for i in range(nc):
        cs.append(c_prev)
        ns.append(n_prev)
        ms.append(m_prev)
        g_n, m_n = g_chunk[:, i], m_chunk[:, i]
        m_new = torch.maximum(m_prev + g_n, m_n)
        sc_prev = torch.exp(m_prev + g_n - m_new)
        sc_new = torch.exp(m_n - m_new)
        c_prev = c_prev * sc_prev[..., None, None] + c_state[:, i] * sc_new[..., None, None]
        n_prev = n_prev * sc_prev[..., None] + n_state[:, i] * sc_new[..., None]
        m_prev = m_new
    c_prevs = torch.stack(cs, dim=1)                          # (B, NC, H, dh, dh)
    n_prevs = torch.stack(ns, dim=1)
    m_prevs = torch.stack(ms, dim=1)

    # both branches brought to a common stabiliser per position
    m_tot = torch.maximum(m_prevs[:, :, None, :] + cum_f, m_c)   # (B, NC, Q, H)
    sc_int = torch.exp(m_c - m_tot)
    sc_car = torch.exp(m_prevs[:, :, None, :] + cum_f - m_tot)
    num_inter = torch.einsum("bnqhd,bnhde->bnqhe", qf, c_prevs)
    den_inter = torch.einsum("bnqhd,bnhd->bnqh", qf, n_prevs)
    num = num_intra * sc_int[..., None] + num_inter * sc_car[..., None]
    den = (qf * den_intra).sum(dim=-1) * sc_int + den_inter * sc_car
    h = num / torch.maximum(den.abs(), torch.exp(-m_tot))[..., None]
    h = h.reshape(bsz, s, d) * torch.sigmoid(u @ p["ogate"]).float()
    return _rms_out(h, p, u.dtype)


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


def _scan(op, elems):
    """Inclusive scan of ``op`` (associative, over tuples of tensors) along
    axis 1 in log2(S) Hillis-Steele rounds: in round r element i combines
    with element i - 2^r."""
    s = elems[0].shape[1]
    d = 1
    while d < s:
        comb = op(tuple(e[:, :s - d] for e in elems),
                  tuple(e[:, d:] for e in elems))
        elems = tuple(torch.cat([e[:, :d], c], dim=1) for e, c in zip(elems, comb))
        d *= 2
    return elems


def _max_plus(a, b):
    return a[0] + b[0], torch.maximum(b[1], b[0] + a[1])


def _linear(a, b):
    """Pairs (A, Bc, Bn) of x_t = A x_{t-1} + B, composed."""
    return a[0] * b[0], b[0] * a[1] + b[1], b[0] * a[2] + b[2]


def slstm_apply(p, u):
    """u (B, S, D) -> (B, S, D): the stabiliser m_t = max(logf_t + m_{t-1},
    logi_t) as a max-plus scan, then c_t = f' c_{t-1} + i' z_t and n_t =
    f' n_{t-1} + i' with f' = exp(logf + m_{t-1} - m_t), i' = exp(logi -
    m_t) as a linear scan."""
    uf = u.float()
    z = torch.tanh((u @ p["wz"]).float())
    logi = uf @ p["wi"]
    logf = log_sigmoid(uf @ p["wf"] + p["f_bias"])
    o = torch.sigmoid(u @ p["wo_gate"]).float()
    _, m = _scan(_max_plus, (logf, logi))
    m_prev = torch.cat([torch.full_like(m[:, :1], M_INIT), m[:, :-1]], dim=1)
    fp = torch.exp(logf + m_prev - m)
    ip = torch.exp(logi - m)
    _, c, n = _scan(_linear, (fp, ip * z, ip))
    h = o * (c / torch.clamp_min(n, 1.0))
    return _rms_out(h, p, u.dtype)
