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

Partitioned over 'model' (``part``, a
:class:`repro_torch.dist.collectives.Part`) sLSTM computes the rank's
block of channels (``wz``/``wi``/``wf``/``wo_gate`` column-parallel, the
scans per channel, ``wo`` row-parallel).  mLSTM splits by heads where they
divide the ranks; where the ranks divide the heads' width instead
(xlstm-1.3b's 4 heads on 8 or 16 ranks), the ranks of a head each hold a
block of its q, k, v and output columns: the q . k scores and the
normaliser's dots are partial sums over the head's ranks
(:func:`repro_torch.dist.collectives.psum` over the
:meth:`~repro_torch.dist.collectives.Part.sub` group), and the matrix
memory keeps the rank's value columns over k's whole head (k and q
gathered over the head's ranks).  ``wi`` / ``wf`` (d, H) split with the
heads or stay whole.  Both blocks' output RMS sums its squares over the
ranks.  The decode state rests whole: a rank reads its share and the new
state is gathered whole.  With one rank every form is the meshless
arithmetic, op for op.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as col
from repro_torch.models.layers import DTYPE, _col_bias, _normal
from repro_torch.models.mamba2 import softplus

M_INIT = -1e30      # the stabiliser's initial value (the reference's -inf stand-in)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def _rms_out(h, p, dtype, part=None):
    """The blocks' output norm (float32 RMS over the whole width, its sum
    of squares summed over the ranks under ``part``; scale ``norm``), back
    in the input's dtype for the output projection ``wo`` (row-parallel
    under ``part``: the parts summed)."""
    ss = (h * h).sum(dim=-1, keepdim=True)
    if part is not None:
        ss = col.psum(ss, part.group)
    h = h * torch.rsqrt(ss / p["norm"].shape[-1] + 1e-6) * _col_bias(p["norm"], part)
    o = h.to(dtype) @ p["wo"]
    return o if part is None else col.sum_parts(o, part.group)


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


def _share(n_heads: int, dh: int, part):
    """The rank's share of the mLSTM heads: (h0, h1, e0, e1, head part),
    heads h0..h1-1 and of each its columns e0..e1-1 of q, k, v and the
    output, and the Part of the ranks that share its head (None where the
    rank's heads are whole: no part, or the heads divide the ranks)."""
    if part is None:
        return 0, n_heads, 0, dh, None
    n, r = part.size, part.rank
    if n_heads % n == 0:
        hl = n_heads // n
        return r * hl, (r + 1) * hl, 0, dh, None
    if n % n_heads or dh % (n // n_heads):
        raise ValueError(f"mlstm: {n_heads} heads of {dh} over {n} ranks")
    k = n // n_heads
    h, j = divmod(r, k)
    e = dh // k
    return h, h + 1, j * e, (j + 1) * e, part.sub(k)


def _gates(p, uf, n_heads: int, h0: int, h1: int, part):
    """(log forget gate, log input gate) of heads h0..h1-1, (..., Hl):
    ``wi`` / ``wf`` are the rank's blocks where they split over the ranks,
    else whole (their columns of the rank's heads taken, entering the
    region); ``f_bias`` is replicated."""
    wi, wf, fb = p["wi"], p["wf"], p["f_bias"]
    if part is not None:
        fb = col.enter(fb, part.group)[h0:h1]
        if wi.shape[-1] == n_heads:
            wi, wf = (col.enter(w, part.group)[..., h0:h1] for w in (wi, wf))
    return log_sigmoid(uf @ wf + fb), uf @ wi


def _whole_mlstm(c, n, m, part, hp, n_heads: int):
    """The new decode state of the rank's share gathered whole over the
    ranks: c (B, H, dh, dh), n (B, H, dh), m (B, H)."""
    g = part.group
    if hp is None:
        return tuple(col.all_gather(t, 1, g) for t in (c, n, m))
    b, _, dh, e = c.shape
    c = col.all_gather(c.reshape(b, dh, e), -1, g).reshape(b, dh, n_heads, dh)
    return (c.permute(0, 2, 1, 3).contiguous(),
            col.all_gather(n.reshape(b, e), -1, g).reshape(b, n_heads, dh),
            col.all_gather(m, 1, g).reshape(b, n_heads, -1)[..., 0].contiguous())


def mlstm_decode(p, u_t, cache, *, n_heads=4, part=None):
    """u_t: (B, 1, D) -> (y_t (B, 1, D), new state {"c", "n", "m"}); with
    ``part`` the rank's share of the heads (the module docstring), the new
    state gathered whole."""
    bsz, _, d = u_t.shape
    dh = d // n_heads
    h0, h1, e0, e1, hp = _share(n_heads, dh, part)
    hl, e = h1 - h0, e1 - e0
    x = u_t if part is None else col.enter(u_t, part.group)
    q = (x @ p["wq"]).reshape(bsz, hl, e).float() * dh ** -0.5
    k = (x @ p["wk"]).reshape(bsz, hl, e).float() * dh ** -0.5
    v = (x @ p["wv"]).reshape(bsz, hl, e).float()
    logf, logi = _gates(p, x[:, 0].float(), n_heads, h0, h1, part)   # (B, Hl)
    c, n, m = cache["c"], cache["n"], cache["m"]
    if part is not None:
        c, n, m = c[:, h0:h1, :, e0:e1], n[:, h0:h1, e0:e1], m[:, h0:h1]
    m_new = torch.maximum(m + logf, logi)
    sc_old = torch.exp(m + logf - m_new)
    sc_in = torch.exp(logi - m_new)
    kr = k if hp is None else col.gather(k, -1, hp.group, reduce=True)
    c = c * sc_old[..., None, None] + sc_in[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", kr, v)
    n = n * sc_old[..., None] + sc_in[..., None] * k
    qr = q if hp is None else col.gather(q, -1, hp.group, reduce=True)
    num = torch.einsum("bhd,bhde->bhe", qr, c)
    den = torch.einsum("bhd,bhd->bh", q, n)
    if hp is not None:
        den = col.psum(den, hp.group)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(bsz, 1, hl * e) * torch.sigmoid(x @ p["ogate"]).float()
    out = _rms_out(h, p, u_t.dtype, part)
    if part is not None:
        c, n, m_new = _whole_mlstm(c, n, m_new, part, hp, n_heads)
    return out, {"c": c, "n": n, "m": m_new}


def mlstm_apply(p, u, *, n_heads=4, chunk=128, part=None):
    """Chunkwise-parallel mLSTM, u (B, S, D) -> (B, S, D); with ``part``
    the rank's share of the heads (the module docstring).  The intra-chunk
    weights are masked to -1e30 BEFORE the ``exp`` (the discarded entries
    overflow and would make the gradients NaN)."""
    bsz, s, d = u.shape
    dh = d // n_heads
    h0, h1, e0, e1, hp = _share(n_heads, dh, part)
    hl, e = h1 - h0, e1 - e0
    if part is not None:
        u = col.enter(u, part.group)
    uf = u.float()
    q = (u @ p["wq"]).reshape(bsz, s, hl, e).float() * dh ** -0.5
    k = (u @ p["wk"]).reshape(bsz, s, hl, e).float() * dh ** -0.5
    v = (u @ p["wv"]).reshape(bsz, s, hl, e).float()
    logf, logi = _gates(p, uf, n_heads, h0, h1, part)        # (B, S, Hl)

    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    shp = (bsz, nc, chunk, hl)
    qf, kf, vf = (t.reshape(*shp, e) for t in (q, k, v))
    lf, li = logf.reshape(shp), logi.reshape(shp)

    cum_f = torch.cumsum(lf, dim=2)                           # (B, NC, Q, H)
    m_c = (li - cum_f).amax(dim=2, keepdim=True)              # per-chunk stabiliser
    dec = cum_f[:, :, :, None, :] - cum_f[:, :, None, :, :] + li[:, :, None, :, :]
    qi = torch.arange(chunk, device=u.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    w_int = torch.exp(torch.where(causal, dec - m_c[:, :, :, None, :], -1e30))
    scores = torch.einsum("bnqhd,bnthd->bnqth", qf, kf)
    if hp is not None:                 # q . k over the head's columns
        scores = col.psum(scores, hp.group)
    num_intra = torch.einsum("bnqth,bnthd->bnqhd", scores * w_int, vf)
    den_intra = torch.einsum("bnqth,bnthd->bnqhd", w_int, kf)

    # the matrix memory's rows are k's whole head, its columns v's (the rank's)
    kr = kf if hp is None else col.gather(kf, -1, hp.group, reduce=True)
    to_end = torch.exp(cum_f[:, :, -1:, :] - cum_f + li - m_c)   # (B, NC, Q, H)
    c_state = torch.einsum("bnthd,bnthe->bnhde", to_end[..., None] * kr, vf)
    n_state = torch.einsum("bnth,bnthd->bnhd", to_end, kf)
    g_chunk = cum_f[:, :, -1, :]                              # (B, NC, H)
    m_chunk = m_c[:, :, 0, :]

    f32 = dict(dtype=torch.float32, device=u.device)
    c_prev = torch.zeros((bsz, hl, kr.shape[-1], e), **f32)
    n_prev = torch.zeros((bsz, hl, e), **f32)
    m_prev = torch.full((bsz, hl), M_INIT, **f32)
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
    c_prevs = torch.stack(cs, dim=1)                          # (B, NC, H, dh, e)
    n_prevs = torch.stack(ns, dim=1)
    m_prevs = torch.stack(ms, dim=1)

    # both branches brought to a common stabiliser per position
    m_tot = torch.maximum(m_prevs[:, :, None, :] + cum_f, m_c)   # (B, NC, Q, H)
    sc_int = torch.exp(m_c - m_tot)
    sc_car = torch.exp(m_prevs[:, :, None, :] + cum_f - m_tot)
    qr = qf if hp is None else col.gather(qf, -1, hp.group, reduce=True)
    num_inter = torch.einsum("bnqhd,bnhde->bnqhe", qr, c_prevs)
    den_inter = torch.einsum("bnqhd,bnhd->bnqh", qf, n_prevs)
    num = num_intra * sc_int[..., None] + num_inter * sc_car[..., None]
    den = (qf * den_intra).sum(dim=-1) * sc_int + den_inter * sc_car
    if hp is not None:                 # the normaliser's dot over the head
        den = col.psum(den, hp.group)
    h = num / torch.maximum(den.abs(), torch.exp(-m_tot))[..., None]
    h = h.reshape(bsz, s, hl * e) * torch.sigmoid(u @ p["ogate"]).float()
    return _rms_out(h, p, u.dtype, part)


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


def _slstm_gates(p, x, part):
    """(z, log input gate, log forget gate, output gate) of the rank's
    channels (all without a part), float32."""
    if part is not None:
        x = col.enter(x, part.group)
    u = x.float()
    return (torch.tanh((x @ p["wz"]).float()), u @ p["wi"],
            log_sigmoid(u @ p["wf"] + _col_bias(p["f_bias"], part)),
            torch.sigmoid(x @ p["wo_gate"]).float())


def slstm_decode(p, u_t, cache, part=None):
    """u_t: (B, 1, D) -> (y_t (B, 1, D), new state {"c", "n", "m"}); with
    ``part`` the rank's block of the channels, the new state gathered
    whole."""
    z, logi, logf, o = _slstm_gates(p, u_t[:, 0], part)
    c, n, m = cache["c"], cache["n"], cache["m"]
    if part is not None:
        c, n, m = (part.block(t, -1) for t in (c, n, m))
    m_new = torch.maximum(logf + m, logi)
    keep = torch.exp(logf + m - m_new)
    take = torch.exp(logi - m_new)
    c = keep * c + take * z
    n = keep * n + take
    h = o * (c / torch.clamp_min(n, 1.0))
    out = _rms_out(h[:, None, :], p, u_t.dtype, part)
    if part is not None:
        c, n, m_new = (col.all_gather(t, -1, part.group) for t in (c, n, m_new))
    return out, {"c": c, "n": n, "m": m_new}


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


def slstm_apply(p, u, part=None):
    """u (B, S, D) -> (B, S, D): the stabiliser m_t = max(logf_t + m_{t-1},
    logi_t) as a max-plus scan, then c_t = f' c_{t-1} + i' z_t and n_t =
    f' n_{t-1} + i' with f' = exp(logf + m_{t-1} - m_t), i' = exp(logi -
    m_t) as a linear scan; with ``part`` over the rank's block of the
    channels (the scans are per channel)."""
    z, logi, logf, o = _slstm_gates(p, u, part)
    _, m = _scan(_max_plus, (logf, logi))
    m_prev = torch.cat([torch.full_like(m[:, :1], M_INIT), m[:, :-1]], dim=1)
    fp = torch.exp(logf + m_prev - m)
    ip = torch.exp(logi - m)
    _, c, n = _scan(_linear, (fp, ip * z, ip))
    h = o * (c / torch.clamp_min(n, 1.0))
    return _rms_out(h, p, u.dtype, part)
