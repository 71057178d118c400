"""GQA and MLA attention: parameters, projections, the dense-cache decode,
full-sequence attention and cross attention (port of
``repro/models/attention.py``).

``gqa_decode`` and ``mla_decode`` attend over the full (dense) cache of
``gqa_init_cache`` / ``mla_init_cache`` (or a rank's block of its
sequence, below) in float32, as the reference computes them outside any
Pallas kernel; the new K/V (or MLA's latent and rope key) is written at
``pos`` in place.  ``pos`` is the cache's ()
int32 position tensor, read on the device (no host sync).  The paged
decode reads MLA through the absorbed latent query of ``models/decode.py``.
``sdpa``, ``sdpa_chunked`` and ``gqa_apply`` attend over a whole sequence
(whisper's bidirectional encoder) and ``cross_apply`` over another stream's
keys and values (an image's patches, the encoder's output), plain torch in
float32 as the reference's.  ``mla_apply`` is MLA's training form: the
latent KV decompressed on the fly, then the causal ``sdpa_chunked``.

Partitioned over 'model' (``part``, a
:class:`repro_torch.dist.collectives.Part`; every arch over a mesh),
``wq``/``wk``/``wv`` are the rank's column blocks and ``wo`` its row
block: the input (and cross attention's ``kv_src``) enters the region,
the rank projects its columns (plus its block of a replicated bias) and
``wo``'s partial products are summed over the ranks.  The core of
:func:`gqa_apply` (train, forward and prefill; the encoder's bidirectional
blocks) and of :func:`cross_apply` (train, prefill and the decode step's
cross step) is split n ways in one of four forms (:func:`core_form`):

  * heads: where the query heads and the kv heads both divide n, a column
    block is whole heads, and the core runs on the rank's heads;
  * rows: where they do not (llama3.2-3b's 24/8 and qwen1.5-4b's 20/20 on
    16) and the query length divides n, the projected query columns are
    exchanged (an all-to-all) into a split over the query rows, K and V
    are all-gathered (backward a reduce-scatter: each rank's rows reach
    every key), the core runs on the rank's rows over every key, and its
    output is exchanged back into column blocks for ``wo`` — what XLA's
    partitioner does with the reference's program;
  * head columns ("cols"): where neither divides but n is a multiple of
    the heads (as many kv heads) and n / h divides the head's width
    (whisper's 8 heads on 16 ranks, its encoder's 1,500 frames), the n / h
    ranks of a head each hold a block of its columns: the q . k products
    are partial sums over the head's ranks, summed over its
    :meth:`~repro_torch.dist.collectives.Part.sub` group
    (:func:`repro_torch.dist.collectives.psum`), and each rank keeps its
    columns of the output for ``wo``'s rows; RoPE, which pairs columns
    across the blocks, turns q and k gathered over the head's ranks;
  * whole: otherwise (a decode step's one query where the heads do not
    divide) the core runs whole on gathered q, k and v, then the
    output's block.

The decode cores (:func:`gqa_decode` over the dense cache,
``decode._paged_attn_block`` over the ring) attend at one query position
on q, k and v gathered whole over the ranks, and hand the rank's block of
the output columns to the row-parallel ``wo``.  MLA (:func:`mla_apply`,
:func:`mla_decode`) splits by heads: the rank's column blocks of ``wq_a``
and ``wkv_a`` gathered whole (the norms and the rope key read whole rows),
its heads through its blocks of ``wq_b`` and ``wkv_b``, ``wo``'s row
parts summed; its decode core attends with the absorbed queries gathered
over the heads.

The split cache (``seq``, a Part of 'model'): over a mesh the dense cache
rests with its sequence dim split over 'model' (``cache_pspecs``), and
:func:`gqa_decode` / :func:`mla_decode` take the rank's block, (B, Smax/n,
Hkv, dh) or (B, Smax/n, kv_lora | d_rope), whose first position is
``rank * Smax/n``.  The rank that holds ``pos`` writes the new row there
(every other rank writes its clamped row back, no host sync); the core
masks the block's keys by their global positions (causal, gemma2's
window, the softcap before the mask), attends over them, and the ranks'
normalised outputs are merged by their softmax statistics (:func:`_merge`:
the max over the ranks, each rank's sum rescaled to it, the outputs
weighted by their share of the sum and summed), as XLA's partitioner runs
the reference's program on that cache.  A rank whose block lies wholly
past ``pos`` adds exactly 0.  With one rank in the part every form is the
meshless arithmetic, op for op (the split cache's share is exactly 1)."""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as col
from repro_torch.models.layers import DTYPE, _col_bias, _normal, apply_rope

NEG_INF = -1e30


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


def _proj_cols(p, x, part=None, kv_src=None):
    """q, k and v flat (B, S, columns): every column, or with ``part`` the
    rank's blocks (``x`` entering the region); k and v projected from
    ``kv_src`` (cross attention, entering the region too) or from ``x``."""
    if part is not None:
        x = col.enter(x, part.group)
        if kv_src is not None:
            kv_src = col.enter(kv_src, part.group)
    elif kv_src is not None:
        # a node of its own, as the region's enter is: k's and v's gradients
        # sum there before they join those of the other layers that read the
        # stream (whisper's encoder output), in the same order in both forms
        kv_src = kv_src.view_as(kv_src)
    kv = x if kv_src is None else kv_src
    q = x @ p["wq"]
    k = kv @ p["wk"]
    v = kv @ p["wv"]
    if "bq" in p:
        q, k, v = (q + _col_bias(p["bq"], part), k + _col_bias(p["bk"], part),
                   v + _col_bias(p["bv"], part))
    return q, k, v


def _proj_qkv(p, x, h, hkv, dh, part=None):
    """q (B, S, H, dh), k and v (B, S, Hkv, dh); with ``part`` projected on
    the rank's column blocks and gathered whole over its ranks (the decode
    cores' replicated form)."""
    b, s, _ = x.shape
    q, k, v = _proj_cols(p, x, part)
    if part is not None:
        q, k, v = (col.gather(t, 2, part.group, reduce=True) for t in (q, k, v))
    return (q.reshape(b, s, h, dh), k.reshape(b, s, hkv, dh),
            v.reshape(b, s, hkv, dh))


def out_proj(p, o, part=None):
    """``o`` (B, S, H*dv) through ``wo``: whole, or with ``part`` the rank's
    block of o's columns through its row block, the parts summed."""
    if part is None:
        return o @ p["wo"]
    return col.sum_parts(part.block(o, -1) @ p["wo"], part.group)


def gqa_init_cache(batch, smax, hkv, dh, dtype=DTYPE, device="cuda"):
    return {"k": torch.zeros((batch, smax, hkv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, smax, hkv, dh), dtype=dtype, device=device)}


def _pos_col(pos: torch.Tensor, b: int) -> torch.Tensor:
    """Decode positions as a (B, 1) column: ``pos`` is the scalar lockstep
    counter or a (B,) vector of per-lane positions."""
    return pos.reshape(-1, 1).expand(b, 1)


def _first(cache: torch.Tensor, seq) -> int:
    """The global position of the first row of ``cache``'s sequence dim: 0,
    or with ``seq`` (a Part) the first of the rank's block."""
    return 0 if seq is None else seq.rank * cache.shape[1]


def _write_at(cache: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
              seq=None) -> None:
    """``cache[:, pos] = rows`` in place, ``pos`` a () device tensor.  With
    ``seq`` the cache is the rank's block of the sequence: the rank that
    holds ``pos`` writes there, every other rank writes the row at its
    clamped index back (no host sync)."""
    at = pos.reshape(1).long()
    rows = rows.to(cache.dtype)
    if seq is not None:
        n = cache.shape[1]
        at = at - _first(cache, seq)
        own = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        rows = torch.where(own, rows, cache.index_select(1, at))
    cache.index_copy_(1, at, rows)


def _key_mask(smax: int, pos: torch.Tensor, window: int = 0,
              first: int = 0) -> torch.Tensor:
    """(smax,) bool: which of the keys at positions ``first`` on are causal
    keys of position ``pos``, and with ``window > 0`` among its last
    ``window``."""
    kpos = torch.arange(first, first + smax, device=pos.device)
    mask = kpos <= pos
    if window > 0:
        mask &= kpos > pos - window
    return mask


def _merge(o: torch.Tensor, s: torch.Tensor, group, dims) -> torch.Tensor:
    """The ranks' attention outputs over their blocks of the keys merged
    into the output over every key: ``o`` the rank's output normalised over
    its keys, ``s`` its masked scores (keys last); ``dims`` permutes the
    statistics (``s``'s dims but the last) into ``o``'s order but its last
    dim.  Each rank's share is its softmax sum rescaled to the global max,
    ``l_r exp(m_r - M)``, over their sum; a rank whose keys are all masked
    (m = NEG_INF) adds exactly 0.  With one rank the share is exactly 1."""
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    a = l * torch.exp(m - col.max_over(m, group))
    share = a / col.all_reduce(a.clone(), group)
    return col.all_reduce(o * share.permute(dims)[..., None], group)


def dense_attend(q, ck, cv, pos, *, window=0, softcap=0.0, scale, seq=None):
    """One query position over the full cache, in float32: q (B, 1, H, dh),
    ck/cv (B, Smax, Hkv, dh) -> (B, 1, Hkv, g, dh) float32, the reference's
    einsum / mask / softmax / einsum with the scores softcapped before the
    mask and masked to ``NEG_INF``.  With ``seq`` (a Part) ck/cv are the
    rank's block of the sequence, masked by their global positions, and the
    ranks' outputs are merged over ``seq``'s group (:func:`_merge`)."""
    b, _, h, dh = q.shape
    hkv = ck.shape[2]
    qf = q.float().reshape(b, 1, hkv, h // hkv, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, ck.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    mask = _key_mask(ck.shape[1], pos, window, _first(ck, seq))
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, cv.float())
    return o if seq is None else _merge(o, s, seq.group, (0, 3, 1, 2))


def gqa_decode(p, x_t, cache, pos, *, h, hkv, dh, rope_theta=10000.0,
               window=0, softcap=0.0, scale=None, part=None, seq=None):
    """x_t (B, 1, D) at position ``pos``: the full-cache decode.  Writes the
    new K/V into ``cache`` in place; returns (B, 1, D).  ``part``: the
    module docstring's decode form; ``seq``: the cache is the rank's block
    of the sequence (the module docstring's split cache)."""
    b = x_t.shape[0]
    q, k, v = _proj_qkv(p, x_t, h, hkv, dh, part)
    if rope_theta > 0:
        pos_b = _pos_col(pos, b)
        q = apply_rope(q, pos_b, rope_theta)
        k = apply_rope(k, pos_b, rope_theta)
    _write_at(cache["k"], pos, k, seq)
    _write_at(cache["v"], pos, v, seq)
    scale = (dh ** -0.5) if scale is None else scale
    o = dense_attend(q, cache["k"], cache["v"], pos, window=window,
                     softcap=softcap, scale=scale, seq=seq)
    return out_proj(p, o.reshape(b, 1, h * dh).to(x_t.dtype), part)


# -- full-sequence attention (the encoder) and cross attention -------------------

def sdpa(q, k, v, *, causal=True, window: int = 0, softcap: float = 0.0,
         scale=None, q_offset: int = 0, k_offset: int = 0, reduce=None):
    """q (B, Sq, H, dh) over k/v (B, Sk, Hkv, dh|dv) in float32, rounded
    back to q's dtype: the reference's einsum / softcap / mask / softmax /
    einsum.  ``window > 0`` keeps only the last ``window`` keys of each
    query; ``q_offset`` / ``k_offset`` are the absolute positions of q[0]
    and k[0]; ``reduce`` completes the q . k products before they are
    scaled (a rank's partial sums over its block of each head's columns,
    summed over the head's ranks)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = (dh ** -0.5) if scale is None else scale
    qf = q.float().reshape(b, sq, hkv, h // hkv, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if reduce is not None:
        s = reduce(s)
    s = s * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :] + k_offset
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


CHUNK_Q = 512          # query-chunked attention kicks in above this length


def sdpa_chunked(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                 chunk=CHUNK_Q, q_offset: int = 0, reduce=None):
    """:func:`sdpa` one chunk of ``chunk`` queries at a time, as the
    reference's scan; a length of at most ``chunk`` or not a multiple of it
    (whisper's 1,500 frames) takes the plain path.  A causal sliding-window
    chunk attends over only the ``window + chunk`` keys it can reach.
    ``q_offset`` is q[0]'s position among the keys (a rank's query rows);
    ``reduce`` as :func:`sdpa`'s."""
    sq = q.shape[1]
    if sq <= chunk or sq % chunk != 0:
        return sdpa(q, k, v, causal=causal, window=window, softcap=softcap,
                    scale=scale, q_offset=q_offset, reduce=reduce)
    sk = k.shape[1]
    kv_span = min(sk, window + chunk) if (window > 0 and causal) else sk
    outs = []
    for i in range(sq // chunk):
        at = q_offset + i * chunk
        start = min(max(at - (kv_span - chunk), 0), sk - kv_span)
        outs.append(sdpa(q[:, i * chunk:(i + 1) * chunk],
                         k[:, start:start + kv_span], v[:, start:start + kv_span],
                         causal=causal, window=window, softcap=softcap,
                         scale=scale, q_offset=at, k_offset=start, reduce=reduce))
    return torch.cat(outs, dim=1)


def core_form(h: int, hkv: int, s: int, n: int, dh: int) -> str:
    """How :func:`gqa_apply` and :func:`cross_apply` split their core of
    ``h`` / ``hkv`` heads of ``dh`` over n ranks: "heads", "rows", "cols"
    (head columns) or "whole" (the module docstring); ``s`` is the query
    length."""
    if h % n == 0 and hkv % n == 0:
        return "heads"
    if s % n == 0:
        return "rows"
    if hkv == h and n % h == 0 and dh % (n // h) == 0:
        return "cols"
    return "whole"


def _attend(p, q, k, v, *, h, hkv, dh, form, part, core=None, pos=None,
            rope_theta=0.0, **kw):
    """The core over the rank's projected columns q (B, Sq, .), k and v
    (B, Sk, .) in ``form``, then ``wo``: RoPE at ``pos`` (queries and keys
    of one sequence) where ``rope_theta > 0``, ``core`` (:func:`sdpa_chunked`
    by default) with ``kw``."""
    core = core or sdpa_chunked
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    rope = pos is not None and rope_theta > 0
    if form == "rows":
        n, r = part.size, part.rank
        q = col.exchange(q, 1, 2, part.group)              # (B, Sq/n, H*dh)
        k, v = (col.gather(t, 2, part.group, reduce=True) for t in (k, v))
        rows = sq // n
        q = q.reshape(b, rows, h, dh)
        k, v = k.reshape(b, sk, hkv, dh), v.reshape(b, sk, hkv, dh)
        if rope:
            q = apply_rope(q, pos[..., r * rows:(r + 1) * rows], rope_theta)
            k = apply_rope(k, pos, rope_theta)
        o = core(q, k, v, q_offset=r * rows, **kw)
        o = col.exchange(o.reshape(b, rows, h * dh), 2, 1, part.group)
        return col.sum_parts(o @ p["wo"], part.group)
    if form == "cols":
        # n / h ranks a head, each with a block of its columns: q . k summed
        # over the head's ranks, each rank keeping its columns of the output
        hp = part.sub(part.size // h)
        e = dh // hp.size
        q, k, v = q.reshape(b, sq, 1, e), k.reshape(b, sk, 1, e), v.reshape(b, sk, 1, e)
        if rope:                       # RoPE pairs columns across the blocks
            q, k = (hp.block(apply_rope(col.gather(t, -1, hp.group, reduce=True), pos,
                                        rope_theta), -1) for t in (q, k))
        if kw.get("scale") is None:
            kw["scale"] = dh ** -0.5
        o = core(q, k, v, reduce=lambda s: col.psum(s, hp.group), **kw)
        return col.sum_parts(o.reshape(b, sq, e) @ p["wo"], part.group)
    if form == "heads":
        n = part.size
        q, k, v = (q.reshape(b, sq, h // n, dh), k.reshape(b, sk, hkv // n, dh),
                   v.reshape(b, sk, hkv // n, dh))
    else:
        if part is not None:
            q, k, v = (col.gather(t, 2, part.group, reduce=True) for t in (q, k, v))
        q, k, v = (q.reshape(b, sq, h, dh), k.reshape(b, sk, hkv, dh),
                   v.reshape(b, sk, hkv, dh))
    if rope:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    o = core(q, k, v, **kw)
    o = o.reshape(b, sq, q.shape[2] * dh)
    if form == "heads":
        return col.sum_parts(o @ p["wo"], part.group)
    return out_proj(p, o, part)


def gqa_apply(p, x, *, h, hkv, dh, rope_theta=10000.0, causal=True,
              window=0, softcap=0.0, positions=None, scale=None, part=None):
    """Full-sequence GQA over x (B, S, D): RoPE at ``positions`` (default
    0..S-1), :func:`sdpa_chunked`, then ``wo``; with ``part`` partitioned
    (the module docstring)."""
    s = x.shape[1]
    pos = torch.arange(s, device=x.device)[None, :] if positions is None \
        else positions
    form = "whole" if part is None else core_form(h, hkv, s, part.size, dh)
    q, k, v = _proj_cols(p, x, part)
    return _attend(p, q, k, v, h=h, hkv=hkv, dh=dh, form=form, part=part, pos=pos,
                   rope_theta=rope_theta, causal=causal, window=window,
                   softcap=softcap, scale=scale)


def cross_apply(p, x, kv_src, *, h, hkv, dh, part=None):
    """Cross attention: queries from x (B, Sq, D), keys and values projected
    from ``kv_src`` (B, Sk, D) with no RoPE, every key visible (:func:`sdpa`).
    The reference caches nothing of it: each call projects all of
    ``kv_src``.  With ``part`` both enter the region, the rank projects its
    column blocks (k and v of every ``kv_src`` position) and the core runs
    in :func:`core_form`'s form over the query length (the module
    docstring)."""
    form = "whole" if part is None else core_form(h, hkv, x.shape[1], part.size, dh)
    q, k, v = _proj_cols(p, x, part, kv_src)
    return _attend(p, q, k, v, h=h, hkv=hkv, dh=dh, form=form, part=part, core=sdpa,
                   causal=False)


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


def mla_init_cache(batch, smax, kv_lora=512, d_rope=64, dtype=DTYPE,
                   device="cuda"):
    """MLA caches the compressed latent and the rope key, not K and V."""
    return {"c_kv": torch.zeros((batch, smax, kv_lora), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, smax, d_rope), dtype=dtype, device=device)}


def _mla_latent(p, x, part=None):
    """MLA's two low-rank projections of x: the normed query latent
    ``rms(x @ wq_a)`` (B, S, q_lora) and ``x @ wkv_a`` (B, S, kv_lora +
    d_rope); with ``part`` each is the rank's column block gathered whole
    over the ranks (backward the gradient's block summed over them), and
    the replicated ``q_norm`` enters the region (its gradient summed)."""
    q_norm = p["q_norm"]
    if part is not None:
        x, q_norm = col.enter(x, part.group), col.enter(q_norm, part.group)
    qa, kv_a = x @ p["wq_a"], x @ p["wkv_a"]
    if part is not None:
        qa, kv_a = (col.gather(t, -1, part.group, reduce=True) for t in (qa, kv_a))
    return _rms(qa, q_norm), kv_a


def _kv_norm(p, part=None):
    """``kv_norm``, entering the region under ``part``."""
    return p["kv_norm"] if part is None else col.enter(p["kv_norm"], part.group)


def _mla_heads(h: int, part) -> int:
    """The query heads a rank's column blocks of ``wq_b`` / ``wkv_b`` hold:
    all, or with ``part`` its ``h / n`` (0 where the heads do not divide)."""
    if part is None:
        return h
    return h // part.size if h % part.size == 0 else 0


def mla_decode(p, x_t, cache, pos, *, h, q_lora=1536, kv_lora=512,
               d_nope=128, d_rope=64, d_v=128, rope_theta=10000.0, part=None,
               seq=None):
    """MLA's absorbed decode over the full latent cache, in float32: the
    nope query goes through the key half of ``wkv_b`` into the latent
    space, the attention output back through its value half.  Writes the
    latent and rope key at ``pos`` in place; returns (B, 1, D).

    With ``part`` (the heads divide its ranks) the rank projects its heads'
    queries into the latent space and the absorbed queries are gathered
    over the heads, so that the core attends with every head, as the dense
    decoders' decode form; the rank then takes its heads of the latent
    output through its block of ``wkv_b``'s value half and ``wo``'s rows,
    the parts summed.  With ``seq`` the cache is the rank's block of the
    sequence: the core attends over it and the ranks' latent outputs are
    merged (:func:`_merge`) before the rank takes its heads."""
    b = x_t.shape[0]
    hl = _mla_heads(h, part)
    if not hl:
        raise ValueError(f"mla_decode: {h} heads do not divide {part.size} ranks")
    pos_b = _pos_col(pos, b)
    qa, kv_a = _mla_latent(p, x_t, part)
    q = (qa @ p["wq_b"]).reshape(b, 1, hl, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, pos_b, rope_theta)
    c_t = _rms(kv_a[..., :kv_lora], _kv_norm(p, part))
    kr_t = apply_rope(kv_a[..., None, kv_lora:], pos_b, rope_theta)[:, :, 0]
    _write_at(cache["c_kv"], pos, c_t, seq)
    _write_at(cache["k_rope"], pos, kr_t, seq)
    c_kv, k_rope = cache["c_kv"].float(), cache["k_rope"].float()
    wkv_b = p["wkv_b"].reshape(kv_lora, hl, d_nope + d_v)
    w_k, w_v = wkv_b[..., :d_nope].float(), wkv_b[..., d_nope:].float()
    q_lat = torch.einsum("bqhd,khd->bqhk", q_nope.float(), w_k)
    q_rope = q_rope.float()
    if part is not None:               # the core attends over every head
        q_lat, q_rope = (col.gather(t, 2, part.group, reduce=True)
                         for t in (q_lat, q_rope))
    s_lat = torch.einsum("bqhk,bsk->bhqs", q_lat, c_kv)
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope)
    s = (s_lat + s_rope) * (d_nope + d_rope) ** -0.5
    s = torch.where(_key_mask(c_kv.shape[1], pos, first=_first(c_kv, seq)), s,
                    NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqs,bsk->bqhk", w, c_kv)
    if seq is not None:
        o_lat = _merge(o_lat, s, seq.group, (0, 2, 1))
    if part is not None:
        o_lat = part.block(o_lat, 2)
    o = torch.einsum("bqhk,khd->bqhd", o_lat, w_v)
    o = o.reshape(b, 1, hl * d_v).to(x_t.dtype) @ p["wo"]
    return o if part is None else col.sum_parts(o, part.group)


def mla_apply(p, x, *, h, q_lora=1536, kv_lora=512, d_nope=128, d_rope=64,
              d_v=128, rope_theta=10000.0, positions=None, part=None):
    """Training-time MLA over x (B, S, D): the low-rank query, the latent
    KV up-projected through ``wkv_b`` into per-head nope keys and values,
    the one rope key broadcast over the heads, then causal
    :func:`sdpa_chunked` at scale (d_nope + d_rope)^-1/2.

    With ``part`` (the heads divide its ranks) the rank's column blocks of
    ``wq_a`` and ``wkv_a`` are gathered whole over the ranks (the norms and
    the rope key read whole rows; at 16 ranks ``wkv_a``'s blocks straddle
    the latent | rope border), the rank projects its heads' queries, keys
    and values through its blocks of ``wq_b`` and ``wkv_b``, attends over
    its heads and sums ``wo``'s row parts."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None, :] if positions is None \
        else positions
    hl = _mla_heads(h, part)
    if not hl:
        raise ValueError(f"mla_apply: {h} heads do not divide {part.size} ranks")
    qa, kv_a = _mla_latent(p, x, part)
    q = (qa @ p["wq_b"]).reshape(b, s, hl, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, pos, rope_theta)
    c_kv = _rms(kv_a[..., :kv_lora], _kv_norm(p, part))
    k_rope = apply_rope(kv_a[..., None, kv_lora:], pos, rope_theta)  # (B, S, 1, dr)
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, hl, d_nope + d_v)
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]
    k = torch.cat([k_nope, k_rope.expand(b, s, hl, d_rope)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    o = sdpa_chunked(q_full, k, v, causal=True, scale=(d_nope + d_rope) ** -0.5)
    o = o.reshape(b, s, hl * d_v) @ p["wo"]
    return o if part is None else col.sum_parts(o, part.group)
