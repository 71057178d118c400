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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _normal
from repro_torch.models.layers import DTYPE


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


def _split_proj(zxbcdt, d_inner, n_groups, d_state, n_heads):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    b = zxbcdt[..., 2 * d_inner:2 * d_inner + n_groups * d_state]
    c = zxbcdt[..., 2 * d_inner + n_groups * d_state:
               2 * d_inner + 2 * n_groups * d_state]
    dt = zxbcdt[..., -n_heads:]
    return z, x, b, c, dt


def _conv1d(x, w, b, cache=None):
    """Causal depthwise conv.  x: (B, S, C); w: (K, C); cache: (B, K-1, C),
    the previous K-1 input rows (zeros when None).  Returns (silu(conv + b),
    the new cache)."""
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if cache is None else cache
    xp = torch.cat([pad, x], dim=1)                          # (B, S+K-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b), xp[:, -(k - 1):, :]


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


def mamba2_decode(p, u_t, cache, *, headdim=64, n_groups=1, d_state=64):
    """u_t: (B, 1, D) -> (y_t (B, 1, D), new state {"ssm", "conv"}): one
    recurrent SSD step, the reference's ``mamba2_decode``."""
    bsz = u_t.shape[0]
    d_inner = p["out_proj"].shape[0]
    n_heads = d_inner // headdim
    zxbcdt = u_t @ p["in_proj"]
    z, x, b, c, dt = _split_proj(zxbcdt, d_inner, n_groups, d_state, n_heads)
    xbc, conv = _conv1d(torch.cat([x, b, c], dim=-1), p["conv_w"], p["conv_b"],
                        cache["conv"])
    x = xbc[..., :d_inner].reshape(bsz, n_heads, headdim).float()
    b = xbc[..., d_inner:d_inner + n_groups * d_state].reshape(bsz, n_groups, d_state)
    c = xbc[..., d_inner + n_groups * d_state:].reshape(bsz, n_groups, d_state)
    hpg = n_heads // n_groups
    b = b.repeat_interleave(hpg, dim=1).float()
    c = c.repeat_interleave(hpg, dim=1).float()
    dt = softplus(dt[:, 0].float() + p["dt_bias"])           # (B, H)
    a = -torch.exp(p["A_log"])
    g = torch.exp(dt * a)                                    # (B, H)
    st = cache["ssm"] * g[..., None, None] + torch.einsum(
        "bhs,bhp->bhsp", b * dt[..., None], x)
    y = torch.einsum("bhs,bhsp->bhp", c, st)
    y = (y + x * p["D"][None, :, None]).reshape(bsz, 1, d_inner)
    yf = y * F.silu(z.float())
    yf = yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-6) * p["norm"]
    return yf.to(u_t.dtype) @ p["out_proj"], {"ssm": st, "conv": conv}



def mamba2_apply(p, u, *, headdim=64, n_groups=1, d_state=64, chunk=128):
    """u (B, S, D) -> (B, S, D): the chunked SSD scan.  The causal decay
    ``exp(cum[q] - cum[t])`` is masked to -1e30 BEFORE the ``exp``: the
    discarded t > q entries overflow and would make the gradients NaN."""
    bsz, s, _ = u.shape
    d_inner = p["out_proj"].shape[0]
    n_heads = d_inner // headdim
    zxbcdt = u @ p["in_proj"]
    z, x, b, c, dt = _split_proj(zxbcdt, d_inner, n_groups, d_state, n_heads)
    xbc, _ = _conv1d(torch.cat([x, b, c], dim=-1), p["conv_w"], p["conv_b"])
    x = xbc[..., :d_inner].reshape(bsz, s, n_heads, headdim)
    b = xbc[..., d_inner:d_inner + n_groups * d_state].reshape(
        bsz, s, n_groups, d_state)
    c = xbc[..., d_inner + n_groups * d_state:].reshape(bsz, s, n_groups, d_state)
    hpg = n_heads // n_groups                                 # groups over heads
    b = b.repeat_interleave(hpg, dim=2)                      # (B, S, H, N)
    c = c.repeat_interleave(hpg, dim=2)
    dt = softplus(dt.float() + p["dt_bias"])                 # (B, S, H)
    da = dt * -torch.exp(p["A_log"])                         # log-decay

    chunk = min(chunk, s)
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, n_heads, headdim).float()
    bc_ = b.reshape(bsz, nc, chunk, n_heads, d_state).float()
    cc = c.reshape(bsz, nc, chunk, n_heads, d_state).float()
    dac = da.reshape(bsz, nc, chunk, n_heads)
    dtc = dt.reshape(bsz, nc, chunk, n_heads)

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
    st = torch.zeros((bsz, n_heads, d_state, headdim), dtype=torch.float32,
                     device=u.device)
    prev = []                                                 # state BEFORE chunk n
    for n in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                    # (B, NC, H, N, P)

    # inter-chunk: y_t += C_t exp(cum_t) S_prev
    y_inter = torch.einsum("bnqhs,bnhsp->bnqhp", cc * torch.exp(cum)[..., None],
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, n_heads, headdim)
    y = y + xc.reshape(bsz, s, n_heads, headdim) * p["D"][None, None, :, None]
    y = y.reshape(bsz, s, d_inner)
    yf = y * F.silu(z.float())                                # gated RMSNorm
    yf = yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-6) * p["norm"]
    return yf.to(u.dtype) @ p["out_proj"]
