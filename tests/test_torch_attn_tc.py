"""The head-tiled attention kernel's tensor-core arithmetic, emulated in
plain torch on the CPU, against the reference's Pallas kernel.

``csrc/paged_attn.cu::paged_attn_tiled_kernel`` (groups above MAX_GROUP,
MLA's 128 query heads) runs S = q K^T and O += p V as mma.sync over TF32.
bf16 pages are exact in TF32; the float32 q and p are split into
hi = tf32(x) and lo = tf32(x - hi), and f32 pages the same way (3xTF32).
Here:

* ``tf32`` emulates ``cvt.rna.tf32.f32`` on the int32 view (10 significand
  bits kept, round to nearest with ties away from zero, the low 13 bits
  zeroed): every bf16 value passes unchanged, an independent rounding of
  the significand agrees, and hi + lo gives q back within 2^-21 relative.
* ``kernel_emulation`` follows the kernel's decomposition: heads in tiles
  of 32 (zero rows past the group), the cluster ranks' page shares and
  rank-ordered merge (``test_torch_kernels._cluster_shares`` /
  ``_cluster_combine``; the launch picks the cluster size C <= min(P, 8)
  from the card's occupancy, so each case also runs at a smaller C), ring
  items of min(T, 16) rows (8 for f32) in
  softmax segments of at most 64 tokens, k steps of 8 with zero-filled dk,
  the four k quarters' partials summed in order, the select to -1e30 past
  the length, the split p, V rows past the length or the item selected to
  0 (the shared memory behind them is filled with NaN here), and the
  page's own (page_m, page_l) carried across its segments.  All five
  outputs are held to the Pallas kernel (interpret mode) within
  1e-4 + 1e-4*|ref|, the tolerance the kernel is held to on the card.
* the control: with q's and p's lo parts dropped (one TF32 product each)
  the same decomposition fails that tolerance, at MLA's full width and at
  a 37-token page in T = 64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attn import ops as j_pa_ops  # noqa: E402
from test_torch_kernels import _cluster_combine, _cluster_shares  # noqa: E402

HEAD_TILE = 32           # query heads a block
SEGMENT = 64             # tokens a softmax segment, at most
K_SPLIT = 4              # S: k quarters
NEG_INF = -1e30
TOL = 1e-4               # |a - ref| <= TOL + TOL * |ref|
MLA_SCALE = (128 + 64) ** -0.5


def tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 significand bits, to
    nearest with ties away from zero, as float32 with the low 13 bits 0."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """x = hi + lo, two TF32 values."""
    hi = tf32(x)
    return hi, tf32(x - hi)


# -- the TF32 rounding -----------------------------------------------------------

def test_tf32_keeps_every_bf16_value():
    """bf16 has 8 significand bits, TF32 11: every finite bf16 value is a
    TF32 value, so bf16 pages reach the tensor cores unsplit."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = x[torch.isfinite(x)]
    assert x.numel() == 65536 - 256          # exponent 0xff: NaNs, infinities
    assert torch.equal(tf32(x).view(torch.int32), x.view(torch.int32))


def test_tf32_rounds_to_nearest_ties_away():
    """Against an independent rounding of the significand (frexp), on
    random values over 60 decades and on exact ties of both signs."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    tie = (rng.integers(0x00800000, 0x7f000000, 2000, dtype=np.int64) & ~0x1fff) | 0x1000
    ties = tie.astype(np.uint32).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    mant, exp = np.frexp(x.astype(np.float64))          # |mant| in [0.5, 1)
    want = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5) * 2.0 ** (exp - 11)
    got = tf32(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)
    assert (tf32(torch.from_numpy(x)).view(torch.int32).numpy() & 0x1fff == 0).all()


def test_split_gives_q_back_within_2_to_the_minus_21():
    rng = np.random.default_rng(1)
    q = (rng.normal(size=50000) * 10.0 ** rng.uniform(-20, 20, 50000)).astype(np.float32)
    hi, lo = split(torch.from_numpy(q))
    for part in (hi, lo):
        assert (part.view(torch.int32).numpy() & 0x1fff == 0).all()
    err = np.abs(hi.double().numpy() + lo.double().numpy() - q.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(q)).all()


# -- the kernel's decomposition ------------------------------------------------

def _mm(a_hi, a_lo, b_hi, b_lo):
    """One product through the tensor cores: hi*b + lo*b (+ hi*b_lo for f32
    pages), the hi and lo products accumulated apart and added."""
    hi = a_hi @ b_hi
    lo = a_lo @ b_hi
    if b_lo is not None:
        lo = lo + a_hi @ b_lo
    return hi + lo


def _operand(x, f32_pages):
    """Ring values as TF32 operands: bf16 exactly, f32 split."""
    if f32_pages:
        return split(x)
    hi = tf32(x)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    return hi, None


def _item(pages, i, c, tc, rows):
    """Ring item c of page i: ``rows`` rows from token c * tc on; rows past
    the item and past the page are the shared memory behind the box (NaN)."""
    out = torch.full((rows, pages.shape[-1]), float("nan"))
    t = pages.shape[1]
    hi = min(tc, t - c * tc, rows)
    out[:hi] = pages[i, c * tc:c * tc + hi]
    return out


def _rank(q_t, k, v, lens, scale, softcap, f32_pages, lo_parts=True):
    """One block's pages: (m, l, acc) of the tile's heads and each page's
    (page_m, page_l).  ``lo_parts`` False drops q's and p's lo parts (one TF32
    product each, the arithmetic the split is there to avoid)."""
    th, dk = q_t.shape
    n_pages, t, dv = v.shape
    ks = -(-dk // 8)
    pad = 8 * ks - dk
    q_hi, q_lo = split(torch.nn.functional.pad(q_t, (0, pad)))
    q_lo = q_lo if lo_parts else torch.zeros_like(q_lo)
    # the K columns past dk come zero-filled from the TMA box
    k = torch.nn.functional.pad(k, (0, pad))
    tc = min(t, 16 if not f32_pages else 8)
    cps = max(1, SEGMENT // tc)
    nt = -(-tc // 8)
    m = torch.full((th,), NEG_INF)
    l = torch.zeros(th)
    acc = torch.zeros(th, dv)
    pm_out = torch.full((n_pages, th), NEG_INF)
    pl_out = torch.zeros(n_pages, th)
    for i in range(n_pages):
        n = int(lens[i])
        if n == 0:
            continue
        nc = -(-n // tc)
        pm = pl = None
        for c0 in range(0, nc, cps):
            c1 = min(nc, c0 + cps)
            ns = min(n, c1 * tc) - c0 * tc
            width = (c1 - c0) * tc + 8
            s_tile = torch.full((th, width), float("nan"))
            for c in range(c0, c1):
                kt_hi, kt_lo = _operand(_item(k, i, c, tc, 8 * nt), f32_pages)
                parts = []
                for kq in range(K_SPLIT):
                    cols = torch.cat([torch.arange(8 * j, 8 * j + 8)
                                      for j in range(kq, ks, K_SPLIT)]).long() \
                        if kq < ks else torch.zeros(0, dtype=torch.long)
                    parts.append(_mm(q_hi[:, cols], q_lo[:, cols], kt_hi[:, cols].T,
                                     None if kt_lo is None else kt_lo[:, cols].T))
                s = parts[0]
                for x in parts[1:]:
                    s = s + x
                s = s * scale
                if softcap > 0.0:
                    s = softcap * torch.tanh(s / softcap)
                r = torch.arange(8 * nt)
                s = torch.where((c * tc + r < n)[None, :], s, NEG_INF)
                s_tile[:, (c - c0) * tc:(c - c0) * tc + tc] = s[:, :tc]
            seg = s_tile[:, :ns]
            ms = seg.amax(dim=1)
            m_cur = torch.maximum(m, ms)
            p = torch.zeros(th, width)
            p[:, :ns] = torch.exp(seg - m_cur[:, None])
            pm_cur = ms if pm is None else torch.maximum(pm, ms)
            psum = torch.exp(seg - pm_cur[:, None]).sum(dim=1)
            pl = psum if pl is None else pl * torch.exp(pm - pm_cur) + psum
            pm = pm_cur
            alpha = torch.exp(torch.clamp(m - m_cur, max=0.0))
            l = l * alpha + p[:, :ns].sum(dim=1)
            m = m_cur
            p_hi, p_lo = split(p)
            p_lo = p_lo if lo_parts else torch.zeros_like(p_lo)
            acc = acc * alpha[:, None]
            for c in range(c0, c1):
                for kk in range(-(-tc // 8)):
                    r = torch.arange(8 * kk, 8 * kk + 8)
                    vt = _item(v, i, c, tc, 8 * (kk + 1))[8 * kk:]
                    ok = (r < tc) & (c * tc + r < n)
                    vt = torch.where(ok[:, None], vt, 0.0)      # the select
                    v_hi, v_lo = _operand(vt, f32_pages)
                    cols = (c - c0) * tc + r
                    acc = acc + _mm(p_hi[:, cols], p_lo[:, cols], v_hi, v_lo)
        pm_out[i], pl_out[i] = pm, pl
    return m, l, acc, pm_out, pl_out


def _shares(p, c):
    """Page ranges of c cluster ranks, the first p % c ranks one more."""
    share, extra = divmod(p, c)
    starts = [r * share + min(r, extra) for r in range(c)]
    return [(lo, lo + share + (r < extra)) for r, lo in enumerate(starts)]


def kernel_emulation(q, kp, vp, lens, scale, softcap=0.0, f32_pages=False, c=None,
                     lo_parts=True):
    """The head-tiled kernel's (m, l, acc, page_m, page_l), from its head
    tiles, the pages of c cluster ranks (default min(P, 8)) and the
    rank-ordered merge."""
    b, h, dk = q.shape
    _, p, t, hkv, _ = kp.shape
    dv = vp.shape[-1]
    g = h // hkv
    m = torch.empty(b, h, 1)
    l = torch.empty(b, h, 1)
    acc = torch.empty(b, h, dv)
    page_m = torch.empty(b, p, h)
    page_l = torch.empty(b, p, h)
    for bi in range(b):
        for kvh in range(hkv):
            for tile in range(-(-g // HEAD_TILE)):
                h0 = kvh * g + tile * HEAD_TILE
                gt = min(HEAD_TILE, g - tile * HEAD_TILE)
                q_t = torch.zeros(HEAD_TILE, dk)
                q_t[:gt] = q[bi, h0:h0 + gt]
                parts = []
                for lo, hi in _shares(p, c or min(p, 8)):
                    m_r, l_r, acc_r, pm_r, pl_r = _rank(
                        q_t, kp[bi, lo:hi, :, kvh], vp[bi, lo:hi, :, kvh],
                        lens[bi, lo:hi], scale, softcap, f32_pages, lo_parts)
                    parts.append((m_r[:, None], l_r[:, None], acc_r))
                    page_m[bi, lo:hi, h0:h0 + gt] = pm_r[:, :gt]
                    page_l[bi, lo:hi, h0:h0 + gt] = pl_r[:, :gt]
                m_t, l_t, acc_t = _cluster_combine(parts)
                m[bi, h0:h0 + gt] = m_t[:gt]
                l[bi, h0:h0 + gt] = l_t[:gt]
                acc[bi, h0:h0 + gt] = acc_t[:gt]
    return m, l, acc, page_m, page_l


# (b, query heads, kv heads, dk, dv, pages, page_t, lengths, softcap, f32
# pages, junk past the lengths, scale)
CASES = {
    "mla-full-width": (2, 128, 1, 576, 512, 3, 8, [[8, 5, 0], [0, 8, 1]], 0.0,
                       False, False, MLA_SCALE),
    "smoke-widths": (2, 32, 1, 24, 16, 3, 4, [[4, 1, 0], [2, 3, 4]], 0.0, False,
                     True, None),
    "group-48-over-2": (2, 96, 2, 64, 32, 4, 8, [[8, 3, 0, 8], [0, 0, 0, 0]], 0.0,
                        False, False, None),
    "page-t-6": (2, 64, 1, 64, 32, 5, 6, [[6, 2, 0, 6, 1], [5, 6, 6, 3, 0]], 0.0,
                 False, True, None),
    "37-of-64": (1, 64, 1, 128, 64, 3, 64, [[64, 37, 0]], 0.0, False, True, None),
    "softcap-30": (1, 32, 1, 64, 64, 4, 16, [[16, 9, 16, 1]], 30.0, False, False,
                   None),
    "f32-pages": (2, 64, 1, 96, 64, 3, 8, [[8, 3, 0], [5, 8, 1]], 0.0, True, True,
                  None),
    "two-segments": (1, 32, 1, 64, 32, 2, 80, [[80, 70]], 0.0, False, True, None),
}


def _case(name):
    """A case's inputs (numpy draws from a seed of its name) and the Pallas
    kernel's five outputs on them."""
    b, h, hkv, dk, dv, p, t, lens, softcap, f32_pages, junk, scale = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    lens = np.asarray(lens, np.int32)
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    kp = torch.from_numpy(rng.normal(size=(b, p, t, hkv, dk)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(b, p, t, hkv, dv)).astype(np.float32))
    if not f32_pages:
        kp, vp = kp.bfloat16().float(), vp.bfloat16().float()
    if junk:      # the rows past each page's length hold +-1e30
        tok = torch.arange(t)
        past = (tok[None, None, :] >= torch.from_numpy(lens)[:, :, None])[..., None, None]
        big = torch.where(tok % 2 == 0, 1e30, -1e30).bfloat16().float()
        kp = torch.where(past, big[None, None, :, None, None], kp)
        vp = torch.where(past, big[None, None, :, None, None], vp)
    scale = dk ** -0.5 if scale is None else scale
    ref = j_pa_ops.paged_attention_local_stats(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(lens), scale=scale, softcap=softcap, interpret=True,
        return_page_stats=True)
    return (torch.from_numpy(q), kp, vp, torch.from_numpy(lens), scale, softcap,
            f32_pages), ref


def _worst(out, ref):
    """Each output's largest |a - ref| / (TOL + TOL * |ref|): above 1 fails."""
    return {what: float((np.abs(a.numpy() - np.asarray(r))
                         / (TOL + TOL * np.abs(np.asarray(r)))).max())
            for what, a, r in zip(("m", "l", "acc", "page_m", "page_l"), out, ref)}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_emulation_matches_pallas_kernel(name):
    args, ref = _case(name)
    lens = args[3].numpy()
    b, p = lens.shape
    assert _shares(p, min(p, 8)) == _cluster_shares(p)
    for c in sorted({min(p, 8), max(1, min(p, 8) // 2)}, reverse=True):
        out = kernel_emulation(*args, c)
        for what, a, r in zip(("m", "l", "acc", "page_m", "page_l"), out, ref):
            assert not torch.isnan(a).any(), what
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL, atol=TOL,
                                       err_msg=f"{name}, C={c}: {what}")
    m, l, acc = out[:3]
    for bi in range(b):
        if not lens[bi].any():       # an all-masked row
            assert (m[bi] == NEG_INF).all() and (l[bi] == 0).all()
            assert (acc[bi] == 0).all()
    # a valid page's own denominator counts its max token at exp(0) = 1
    assert float(out[4][torch.from_numpy(lens > 0)].min()) >= 1.0 - TOL


@pytest.mark.parametrize("name", ["mla-full-width", "37-of-64"])
def test_gate_rejects_single_tf32_products(name):
    """The control: the same decomposition with q's and p's lo parts dropped
    (one TF32 product each, ~11 significant bits of q and p) fails the
    1e-4 + 1e-4*|ref| gate that the split passes, so the gate tells the
    designed precision from the cheaper one."""
    args, ref = _case(name)
    split_worst = _worst(kernel_emulation(*args), ref)
    single_worst = _worst(kernel_emulation(*args, lo_parts=False), ref)
    assert max(split_worst.values()) < 1.0, split_worst
    assert max(single_worst.values()) > 1.0, single_worst
    # not only on the relative term: the scores' max fails outright
    assert single_worst["m"] > 1.0, single_worst
