"""Mamba2 (SSD) block: parameters, the chunked training form and the
single-token recurrent decode (port of ``repro/models/mamba2.py``).

The decode state is O(1) in the sequence length: ``ssm`` (B, H, N, P)
float32, the SSD state, and ``conv`` (B, K-1, C), the causal convolution's
last K-1 input rows.  :func:`mamba2_decode` is pure — it returns the new
state and the caller commits it (``models/decode.py`` writes it into the
cache in place, under the lane mask).  :func:`mamba2_apply` is the training form, the
chunked state-space duality scan: an attention-like term inside each chunk
and the state carried across chunks.

The reference has no Pallas kernel here; this is plain torch, op for op
the reference's: the convolution sums its K bf16 products in order, and
``softplus`` is ``jax.nn.softplus``'s ``max(x, 0) + log1p(exp(-|x|))``.

Partitioned over 'model' (``part``, a
:class:`repro_torch.dist.collectives.Part`) a rank computes its heads: the
z, x and dt columns of ``in_proj`` and the conv channels of its heads,
their SSD scan and D skip, and its block of the B | C columns and their
conv channels, all-gathered after the conv (every head reads B and C).
``in_proj``'s and ``conv_w``'s column blocks at rest cut across the z | x
| B | C | dt segments, so they are gathered whole first (backward
reduce-scattered: each rank's gradient is its columns').  The gated
RMSNorm's sum of squares over ``d_inner`` is summed over the ranks
(:func:`repro_torch.dist.collectives.psum`), ``out_proj`` is row-parallel
(its rows are the heads' channels) and its parts summed.  The decode
state rests whole on every rank: a rank reads its heads' SSD state and
its channels' conv rows, and the new state is gathered whole.  With one
rank every form is the meshless arithmetic, op for op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.models.layers import DTYPE, _col_bias, _normal


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), term for term."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_init(gen: torch.Generator, d, *, d_state=64, expand=2, headdim=64,
                d_conv=4, n_groups=1, groups: int = 0, device="cuda",
                dtype=DTYPE):
    """The reference's ``mamba2_init`` tree and scales; ``groups > 0``
    stacks that many layers on a leading axis."""
    lead = (groups,) if groups else ()
    d_inner = expand * d
    n_heads = d_inner // headdim
    width = d_inner + 2 * n_groups * d_state          # the conv's channels
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, **f32))
    return {
        "in_proj": _normal(lead + (d, 2 * d_inner + 2 * n_groups * d_state + n_heads),
                           d ** -0.5, gen, device, dtype),
        "conv_w": _normal(lead + (d_conv, width), 0.1, gen, device, dtype),
        "conv_b": torch.zeros(lead + (width,), dtype=dtype, device=device),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),
        "D": torch.ones(lead + (n_heads,), **f32),
        "dt_bias": torch.zeros(lead + (n_heads,), **f32),
        "norm": torch.ones(lead + (d_inner,), **f32),
        "out_proj": _normal(lead + (d_inner, d), d_inner ** -0.5, gen, device, dtype),
    }


def _heads(n_heads: int, part) -> tuple[int, int]:
    """The rank's heads [h0, h1): all of them without a part."""
    if part is None:
        return 0, n_heads
    if n_heads % part.size:
        raise ValueError(f"mamba2: {n_heads} heads do not divide {part.size} ranks")
    hl = n_heads // part.size
    return part.rank * hl, (part.rank + 1) * hl


def _spans(d_inner, bc, n_heads, headdim, part):
    """The rank's columns, as (start, stop) spans in order: of ``in_proj``
    (its heads' z and x, its block of the B | C columns, its heads' dt) and
    of the conv's channels (its heads' x, its B | C block)."""
    h0, h1 = _heads(n_heads, part)
    w = bc if part is None else bc // part.size
    b0 = 0 if part is None else part.rank * w
    x = (h0 * headdim, h1 * headdim)
    proj = [x, (d_inner + x[0], d_inner + x[1]),
            (2 * d_inner + b0, 2 * d_inner + b0 + w),
            (2 * d_inner + bc + h0, 2 * d_inner + bc + h1)]
    return proj, [x, (d_inner + b0, d_inner + b0 + w)]


def _cols(t, spans):
    """``t``'s last-dim columns in ``spans``: ``t`` itself where they are
    all of its columns in order."""
    whole = spans[0][0] == 0 and spans[-1][1] == t.shape[-1] and all(
        a[1] == b[0] for a, b in zip(spans, spans[1:]))
    return t if whole else torch.cat([t[..., a:b] for a, b in spans], dim=-1)


def _conv1d(x, w, b, cache=None):
    """Causal depthwise conv.  x: (B, S, C); w: (K, C); cache: (B, K-1, C),
    the previous K-1 input rows (zeros when None).  Returns (silu(conv + b),
    the new cache)."""
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if cache is None else cache
    xp = torch.cat([pad, x], dim=1)                          # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b), xp[:, -(k - 1):, :]


def _project(p, u, conv_cache, *, headdim, n_groups, d_state, part):
    """``in_proj`` and the causal conv over the rank's columns: u (B, S, D)
    -> (z and the conv's x of the rank's heads (B, S, Hl*P), B and C of
    every group (B, S, G*N), the raw dt of its heads (B, S, Hl), the conv
    rows of its channels after ``conv_cache``)."""
    d_inner = p["norm"].shape[-1]
    gn = n_groups * d_state
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    if part is not None:
        g = part.group
        u, cb = col.enter(u, g), col.enter(cb, g)
        w = col.gather(w, -1, g, reduce=True)
        cw = col.gather(cw, -1, g, reduce=True)
    proj, conv = _spans(d_inner, 2 * gn, d_inner // headdim, headdim, part)
    hd, wbc = proj[0][1] - proj[0][0], proj[2][1] - proj[2][0]
    zxbcdt = u @ _cols(w, proj)
    xbc, rows = _conv1d(zxbcdt[..., hd:2 * hd + wbc], _cols(cw, conv), _cols(cb, conv),
                        None if conv_cache is None else _cols(conv_cache, conv))
    bc = xbc[..., hd:]
    if part is not None:
        bc = col.gather(bc, -1, part.group, reduce=True)
    return (zxbcdt[..., :hd], xbc[..., :hd], bc[..., :gn], bc[..., gn:],
            zxbcdt[..., 2 * hd + wbc:], rows)


def _per_head(t, h0: int, h1: int, hpg: int, dim: int):
    """Groups -> heads h0..h1-1 along ``dim`` (head h reads group h // hpg;
    the heads are whole groups, or lie in one)."""
    hl = h1 - h0
    if hl % hpg and hpg % hl:
        raise ValueError(f"mamba2: heads {h0}..{h1 - 1} cut groups of {hpg}")
    return t.narrow(dim, h0 // hpg, max(1, hl // hpg)).repeat_interleave(
        min(hpg, hl), dim=dim)


def _gated_out(p, y, z, dtype, part):
    """The gated RMSNorm over ``d_inner`` (its sum of squares summed over
    the ranks), then ``out_proj`` (row-parallel: the parts summed)."""
    yf = y * F.silu(z.float())
    ss = (yf * yf).sum(dim=-1, keepdim=True)
    if part is not None:
        ss = col.psum(ss, part.group)
    yf = yf * torch.rsqrt(ss / p["norm"].shape[-1] + 1e-6) * _col_bias(p["norm"], part)
    o = yf.to(dtype) @ p["out_proj"]
    return o if part is None else col.sum_parts(o, part.group)


def mamba2_init_cache(batch, d, *, expand=2, headdim=64, n_groups=1,
                      d_state=64, d_conv=4, lead=(), dtype=DTYPE,
                      device="cuda"):
    """The decode state of one layer (``lead`` stacks it): ``ssm`` zeros
    (B, H, N, P) float32 and ``conv`` zeros (B, K-1, C) in ``dtype`` (the
    reference's bf16; a float32 cache keeps its rows in float32, as the
    reference's becomes after its first float32 step)."""
    d_inner = expand * d
    return {
        "ssm": torch.zeros(lead + (batch, d_inner // headdim, d_state, headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, d_conv - 1,
                                    d_inner + 2 * n_groups * d_state),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, u_t, cache, *, headdim=64, n_groups=1, d_state=64, part=None):
    """u_t: (B, 1, D) -> (y_t (B, 1, D), new state {"ssm", "conv"}): one
    recurrent SSD step, the reference's ``mamba2_decode``; with ``part``
    the rank's heads (the module docstring), the new state gathered whole."""
    bsz = u_t.shape[0]
    n_heads = p["norm"].shape[-1] // headdim
    h0, h1 = _heads(n_heads, part)
    z, x, b, c, dt, conv = _project(p, u_t, cache["conv"], headdim=headdim,
                                    n_groups=n_groups, d_state=d_state, part=part)
    x = x.reshape(bsz, h1 - h0, headdim).float()
    hpg = n_heads // n_groups
    b = _per_head(b.reshape(bsz, n_groups, d_state), h0, h1, hpg, 1).float()
    c = _per_head(c.reshape(bsz, n_groups, d_state), h0, h1, hpg, 1).float()
    dt = softplus(dt[:, 0].float() + _col_bias(p["dt_bias"], part))   # (B, Hl)
    a = -torch.exp(_col_bias(p["A_log"], part))
    g = torch.exp(dt * a)                                    # (B, Hl)
    ssm = cache["ssm"] if part is None else cache["ssm"][:, h0:h1]
    st = ssm * g[..., None, None] + torch.einsum("bhs,bhp->bhsp", b * dt[..., None], x)
    y = torch.einsum("bhs,bhsp->bhp", c, st)
    y = (y + x * _col_bias(p["D"], part)[None, :, None]).reshape(bsz, 1, -1)
    out = _gated_out(p, y, z, u_t.dtype, part)
    if part is not None:
        hd = (h1 - h0) * headdim
        st = col.all_gather(st, 1, part.group)
        conv = torch.cat([col.all_gather(conv[..., :hd], -1, part.group),
                          col.all_gather(conv[..., hd:], -1, part.group)], dim=-1)
    return out, {"ssm": st, "conv": conv}


def mamba2_apply(p, u, *, headdim=64, n_groups=1, d_state=64, chunk=128, part=None):
    """u (B, S, D) -> (B, S, D): the chunked SSD scan, with ``part`` over
    the rank's heads (the module docstring).  The causal decay
    ``exp(cum[q] - cum[t])`` is masked to -1e30 BEFORE the ``exp``: the
    discarded t > q entries overflow and would make the gradients NaN."""
    bsz, s, _ = u.shape
    n_heads = p["norm"].shape[-1] // headdim
    h0, h1 = _heads(n_heads, part)
    hl = h1 - h0
    z, x, b, c, dt, _ = _project(p, u, None, headdim=headdim, n_groups=n_groups,
                                 d_state=d_state, part=part)
    x = x.reshape(bsz, s, hl, headdim)
    hpg = n_heads // n_groups                                 # groups over heads
    b = _per_head(b.reshape(bsz, s, n_groups, d_state), h0, h1, hpg, 2)  # (B, S, Hl, N)
    c = _per_head(c.reshape(bsz, s, n_groups, d_state), h0, h1, hpg, 2)
    dt = softplus(dt.float() + _col_bias(p["dt_bias"], part))   # (B, S, Hl)
    da = dt * -torch.exp(_col_bias(p["A_log"], part))        # log-decay

    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, hl, headdim).float()
    bc_ = b.reshape(bsz, nc, chunk, hl, d_state).float()
    cc = c.reshape(bsz, nc, chunk, hl, d_state).float()
    dac = da.reshape(bsz, nc, chunk, hl)
    dtc = dt.reshape(bsz, nc, chunk, hl)

    cum = torch.cumsum(dac, dim=2)                            # (B, NC, Q, H)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, NC, Q, Q, H)
    qi = torch.arange(chunk, device=u.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    l_mat = torch.exp(torch.where(causal, decay, -1e30))
    scores = torch.einsum("bnqhs,bnths->bnqth", cc, bc_)
    y_intra = torch.einsum("bnqth,bnthp->bnqhp", scores * l_mat,
                           xc * dtc[..., None])

    # chunk states: S_n = sum_t exp(cum_end - cum_t) dt_t b_t x_t^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B, NC, Q, H)
    states = torch.einsum("bnths,bnthp->bnhsp",
                          (decay_to_end * dtc)[..., None] * bc_, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B, NC, H)
    st = torch.zeros((bsz, hl, d_state, headdim), dtype=torch.float32,
                     device=u.device)
    prev = []                                                 # state BEFORE chunk n
    for n in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                    # (B, NC, H, N, P)

    # inter-chunk: y_t += C_t exp(cum_t) S_prev
    y_inter = torch.einsum("bnqhs,bnhsp->bnqhp", cc * torch.exp(cum)[..., None],
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, hl, headdim)
    y = y + xc.reshape(bsz, s, hl, headdim) * _col_bias(p["D"], part)[None, None, :, None]
    return _gated_out(p, y.reshape(bsz, s, hl * headdim), z, u.dtype, part)
