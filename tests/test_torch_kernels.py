"""The port's kernel paths on the CPU (their plain PyTorch versions) against
the reference's Pallas kernels in interpret mode and its jnp oracles.

Integer outputs are compared bitwise.  Attention outputs in float32 within
rtol/atol 3e-5 (summation order differs), in bf16 within 3e-2 (one bf16
rounding of the inputs), as ``tests/test_kernels.py`` holds the reference.
The cluster-split test holds the Hopper kernel's page split and rank merge
to 1e-4 + 1e-4*|ref|, the tolerance the kernel is held to on the card; the
emulations of the sketch update's segment-owned grid and the histogram's
block partials are held bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import sketch as jsk  # noqa: E402
from repro.kernels.cms_hist import cms_hist as j_hist_k  # noqa: E402
from repro.kernels.cms_hist import ops as j_hist_ops  # noqa: E402
from repro.kernels.neoprof_update import neoprof_update as j_ku  # noqa: E402
from repro.kernels.neoprof_update import ref as j_kref  # noqa: E402
from repro.kernels.paged_attn import ops as j_pa_ops  # noqa: E402
from repro.kernels.paged_attn import ref as j_pa_ref  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.kernels.cms_hist import ops as t_hist_ops  # noqa: E402
from repro_torch.kernels.neoprof_update import ops as t_np_ops  # noqa: E402
from repro_torch.kernels.paged_attn import ops as t_pa_ops  # noqa: E402


def _random_sketch(rng, depth, width):
    """A sketch state with live, stale and near-saturated counters."""
    counts = rng.integers(0, 70, (depth, width)).astype(np.int32)
    counts[:, :8] = 65533
    epochs = rng.integers(0, 2, (depth, width)).astype(np.uint8)
    hot = rng.random((depth, width)) < 0.1
    seeds = rng.integers(0, width, (depth, jsk.PAGE_ID_BITS)).astype(np.int32)
    return counts, epochs, hot, seeds


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("width,depth,s", [
    (1 << 10, 2, 128), (1 << 12, 2, 256), (1 << 12, 3, 512),
])
def test_update_plain_matches_pallas_kernel(width, depth, s):
    rng = np.random.default_rng(width + s)
    counts, epochs, hot, seeds = _random_sketch(rng, depth, width)
    ids = rng.integers(-1, 1 << 18, s).astype(np.int32)     # includes padding
    ids[: s // 8] = ids[s // 8]                               # duplicates
    cmax = jsk.SketchParams().counter_max
    out_j = j_ku.sketch_update_pallas(
        jnp.asarray(counts), jnp.asarray(epochs, jnp.int32),
        jnp.asarray(hot, jnp.int32), jnp.asarray(ids), jnp.asarray(seeds),
        jnp.int32(1), cmax, depth=depth, width=width, interpret=True)
    out_r = j_kref.update_ref(
        jnp.asarray(counts), jnp.asarray(epochs, jnp.int32),
        jnp.asarray(hot, jnp.int32), jnp.asarray(ids), jnp.asarray(seeds),
        jnp.int32(1), cmax)
    out_t = t_np_ops.sketch_update_kernel(
        _t(counts), _t(epochs), _t(hot), _t(ids), _t(seeds),
        torch.tensor(1, dtype=torch.uint8), cmax)
    for name, a, r, t in zip(["counts", "epochs", "est", "hot_before"],
                             out_j, out_r, out_t):
        np.testing.assert_array_equal(t.numpy().astype(np.int32), np.asarray(a),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r), err_msg=name)


def test_update_plain_matches_ref_at_main_width():
    """W=16K, S=1024 against the reference's jnp oracle (the Pallas kernel
    at this size is covered by tests/test_kernels.py)."""
    rng = np.random.default_rng(14)
    counts, epochs, hot, seeds = _random_sketch(rng, 2, 1 << 14)
    ids = rng.integers(-1, 1 << 18, 1024).astype(np.int32)
    cmax = jsk.SketchParams().counter_max
    out_r = j_kref.update_ref(
        jnp.asarray(counts), jnp.asarray(epochs, jnp.int32),
        jnp.asarray(hot, jnp.int32), jnp.asarray(ids), jnp.asarray(seeds),
        jnp.int32(0), cmax)
    out_t = t_np_ops.sketch_update_kernel(
        _t(counts), _t(epochs), _t(hot), _t(ids), _t(seeds),
        torch.tensor(0, dtype=torch.uint8), cmax)
    for a, t in zip(out_r, out_t):
        np.testing.assert_array_equal(t.numpy().astype(np.int32), np.asarray(a))


def test_mark_plain_matches_pallas_kernel():
    rng = np.random.default_rng(9)
    _, _, hot, seeds = _random_sketch(rng, 2, 1 << 12)
    ids = rng.integers(-1, 1 << 18, 256).astype(np.int32)
    is_hot = rng.random(256) < 0.3
    out_j = j_ku.sketch_mark_hot_pallas(
        jnp.asarray(hot, jnp.int32), jnp.asarray(ids),
        jnp.asarray(is_hot, jnp.int32), jnp.asarray(seeds), depth=2,
        width=1 << 12, interpret=True)
    out_r = j_kref.mark_hot_ref(jnp.asarray(hot, jnp.int32), jnp.asarray(ids),
                                jnp.asarray(is_hot, jnp.int32), jnp.asarray(seeds))
    out_t = t_np_ops.sketch_mark_hot_kernel(_t(hot), _t(ids), _t(is_hot), _t(seeds))
    np.testing.assert_array_equal(out_t.numpy().astype(np.int32), np.asarray(out_j))
    np.testing.assert_array_equal(np.asarray(out_j), np.asarray(out_r))


@pytest.mark.parametrize("stale", [False, True])
def test_hist_plain_matches_pallas_kernel_and_core(stale):
    sp = jsk.SketchParams(width=1 << 12, depth=2)
    st = jsk.sketch_init(sp)
    rng = np.random.default_rng(5)
    st, _ = jsk.sketch_update(st, jnp.asarray(rng.integers(0, 1 << 16, 4096),
                                              jnp.int32), jnp.int32(1 << 30), sp)
    if stale:   # half the row goes stale: it must read as 0
        st = st._replace(epochs=st.epochs.at[:, ::2].set(7))
    h_kernel = j_hist_ops.sketch_histogram(st, sp, interpret=True)
    h_core = jsk.sketch_histogram(st, sp)
    ts = tsk.SketchState(*[_t(x) for x in st])
    h_port = t_hist_ops.sketch_histogram(ts, tsk.SketchParams(width=1 << 12))
    np.testing.assert_array_equal(h_port.numpy(), np.asarray(h_kernel))
    np.testing.assert_array_equal(np.asarray(h_kernel), np.asarray(h_core))


def _update_segment_owned(counts, epochs, hot, ids, seeds, cur, cmax, seg):
    """``csrc/neoprof_update.cu::update_kernel``'s decomposition in plain
    torch: one block per segment of ``seg`` entries of one lane (a lane
    narrower than ``seg`` is one short segment).  Each block takes the live
    values clamped at cmax, adds the valid ids that hash into its segment,
    saturates, stamps the tags and writes est/hot_before for the
    (lane, id) it owns; each lane's first block owns the padding ids.
    Returns the four outputs and how many blocks wrote each (lane, id)."""
    d, w = counts.shape
    s = ids.shape[0]
    out = (torch.full_like(counts, -7), torch.zeros_like(epochs),
           torch.full((d, s), -7, dtype=torch.int32),
           torch.full((d, s), -7, dtype=torch.int32))
    owners = torch.zeros((d, s), dtype=torch.int32)
    h = tsk.h3_hash(torch.where(ids >= 0, ids, 0), seeds)
    for lane in range(d):
        for lo in range(0, w, seg):
            hi = min(lo + seg, w)
            cnt = torch.where(epochs[lane, lo:hi] == cur,
                              counts[lane, lo:hi].clamp_max(cmax), 0)
            at = h[lane] - lo
            mine = (ids >= 0) & (at >= 0) & (at < hi - lo)
            pos = at[mine].long()
            cnt = cnt.index_add(0, pos, torch.ones(len(pos), dtype=torch.int32))
            cnt = cnt.clamp_max(cmax)
            out[0][lane, lo:hi] = cnt
            out[1][lane, lo:hi] = cur
            out[2][lane, mine] = cnt[pos]
            out[3][lane, mine] = hot[lane, lo:hi][pos].to(torch.int32)
            owners[lane] += mine.to(torch.int32)
            if lo == 0:
                pad = ids < 0
                out[2][lane, pad] = 0
                out[3][lane, pad] = 0
                owners[lane] += pad.to(torch.int32)
    return out, owners


@pytest.fixture(scope="module")
def update_case():
    """D=3, W=4096, 257 ids with padding and duplicates over a sketch with
    stale, live and near-saturated counters; the Pallas kernel's outputs."""
    rng = np.random.default_rng(31)
    depth, width = 3, 1 << 12
    counts, epochs, hot, seeds = _random_sketch(rng, depth, width)
    ids = rng.integers(-1, 1 << 18, 257).astype(np.int32)
    ids[:40] = ids[40]
    ids[41:45] = -1
    cmax = jsk.SketchParams().counter_max
    pallas = j_ku.sketch_update_pallas(
        jnp.asarray(counts), jnp.asarray(epochs, jnp.int32),
        jnp.asarray(hot, jnp.int32), jnp.asarray(ids), jnp.asarray(seeds),
        jnp.int32(1), cmax, depth=depth, width=width, interpret=True)
    return (counts, epochs, hot, ids, seeds, cmax), [np.asarray(x) for x in pallas]


@pytest.mark.parametrize("seg", [2048, 1000, 1024, 8192])
def test_update_segment_owned_matches_plain_and_pallas(update_case, seg):
    """The update kernel's arithmetic: segments of 2048 entries (the
    kernel's) and 1024, which divide W, 1000, which does
    not, and 8192, wider than W, give the plain version's and the Pallas
    kernel's outputs bitwise, and every (lane, id) has exactly one owner
    block."""
    (counts, epochs, hot, ids, seeds, cmax), pallas = update_case
    args = (_t(counts), _t(epochs), _t(hot), _t(ids), _t(seeds),
            torch.tensor(1, dtype=torch.uint8), cmax)
    emulated, owners = _update_segment_owned(*args, seg=seg)
    plain = t_np_ops.sketch_update_kernel(*args)
    assert (owners == 1).all()
    for name, e, p, j in zip(["counts", "epochs", "est", "hot_before"],
                             emulated, plain, pallas):
        assert e.dtype == p.dtype and torch.equal(e, p), name
        np.testing.assert_array_equal(e.numpy().astype(np.int32), j, err_msg=name)


def _hist_block_partial(counts_row0, epochs_row0, cur, edges, chunk, out):
    """``csrc/cms_hist.cu``'s decomposition in plain torch: the row split
    into blocks of ``chunk`` counters.  In a block, a live value below the
    edges' identity prefix less one is its own bin and any other goes
    through a binary search over the 65 edges (clipped to the bins); the
    kernel searches all four values of a thread once one of them needs it,
    which the check below makes immaterial.  Bin-0 hits are counted apart
    from the rest.  ``out`` is zeroed first, as the launcher's memset does,
    and each block adds its bins into it."""
    e = edges.tolist()
    exact = next((i for i, x in enumerate(e) if x != i), len(e))
    w = counts_row0.shape[0]
    out.zero_()
    for lo in range(0, w, chunk):
        live = torch.where(epochs_row0[lo:lo + chunk] == cur,
                           counts_row0[lo:lo + chunk], 0)
        left = torch.zeros_like(live)
        right = torch.full_like(live, len(e))
        while bool((left < right).any()):
            go = left < right
            mid = (left + right) // 2
            le = edges[mid.clamp_max(len(e) - 1).long()] <= live
            left = torch.where(go & le, mid + 1, left)
            right = torch.where(go & ~le, mid, right)
        searched = (left - 1).clamp(0, 63)
        fast = (live >= 0) & (live < exact - 1)
        assert torch.equal(searched[fast], live[fast])
        bins = torch.where(fast, live, searched)
        part = torch.bincount(bins[bins != 0].long(), minlength=64).to(torch.int32)
        part[0] = int((bins == 0).sum())
        out += part
    return out


@pytest.mark.parametrize("chunk", [1024, 1000, 512, 8192])
def test_hist_block_partial_matches_plain_and_pallas(chunk):
    """The histogram kernel's arithmetic: blocks of 1024 counters (the
    kernel's) and 512, which divide W, 1000, which does not, and 8192, wider
    than W, give the plain version's and the Pallas kernel's histogram
    bitwise, on a row of zeros, stale tags, every edge and its neighbours,
    and counter_max; an output that held other values (``torch.empty``
    gives no zeros) is overwritten, and a second call into it agrees."""
    rng = np.random.default_rng(chunk)
    width = 1 << 12
    cmax = jsk.SketchParams().counter_max
    edges = jsk.hist_edges()
    values = np.concatenate([edges, edges - 1, edges + 1, [cmax] * 32])
    counts = np.where(rng.random(width) < 0.8, 0,
                      rng.choice(np.clip(values, 0, cmax), width)).astype(np.int32)
    epochs = rng.integers(0, 2, width).astype(np.uint8)
    epochs[: width // 8] = 1                      # a run of live tags
    cur = torch.tensor(1, dtype=torch.uint8)
    out = torch.full((64,), -7, dtype=torch.int32)
    args = (_t(counts), _t(epochs), cur, _t(edges))
    emulated = _hist_block_partial(*args, chunk, out).clone()
    assert torch.equal(_hist_block_partial(*args, chunk, out), emulated)
    plain = t_hist_ops.hist_kernel(*args)
    pallas = j_hist_k.hist_pallas(jnp.asarray(counts), jnp.asarray(epochs, jnp.int32),
                                  jnp.int32(1), jnp.asarray(edges), width=width,
                                  interpret=True)
    assert torch.equal(emulated, plain)
    np.testing.assert_array_equal(emulated.numpy(), np.asarray(pallas))
    assert int(emulated.sum()) == width


@pytest.mark.parametrize("counter_bits", [8, 12, 16])
def test_histogram_edges_cached_and_equal_reference(counter_bits):
    """``sketch_histogram`` reads its edges from one cached tensor per
    (counter_bits, device), equal to the reference's ``hist_edges``."""
    cpu = torch.device("cpu")
    edges = t_hist_ops.device_edges(counter_bits, cpu)
    assert edges is t_hist_ops.device_edges(counter_bits, cpu)
    assert edges.dtype == torch.int32
    np.testing.assert_array_equal(edges.numpy(), jsk.hist_edges(counter_bits))


def _attn_inputs(seed, b, h, hkv, dk, dv, p, t, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dk)).astype(np.float32)
    kp = rng.standard_normal((b, p, t, hkv, dk)).astype(dtype)
    vp = rng.standard_normal((b, p, t, hkv, dv)).astype(dtype)
    lens = rng.integers(0, t + 1, (b, p)).astype(np.int32)
    lens[:, 0] = np.maximum(lens[:, 0], 1)
    return q, kp, vp, lens


@pytest.mark.parametrize("b,h,hkv,dk,dv,p,t,softcap", [
    (2, 8, 2, 64, 64, 4, 16, 0.0),
    (1, 4, 4, 32, 32, 8, 32, 30.0),
    (3, 8, 1, 576 // 8, 64, 2, 8, 0.0),     # MLA-style dk != dv
    (2, 16, 8, 128, 128, 4, 64, 0.0),
])
def test_paged_attention_plain_matches_pallas_kernel(b, h, hkv, dk, dv, p, t,
                                                     softcap):
    q, kp, vp, lens = _attn_inputs(b * h + p, b, h, hkv, dk, dv, p, t)
    args = [jnp.asarray(x) for x in (q, kp, vp, lens)]
    o_k = j_pa_ops.paged_attention(*args, softcap=softcap, interpret=True)
    o_r = j_pa_ref.paged_attention_ref(*args, softcap=softcap)
    o_t = t_pa_ops.paged_attention(_t(q), _t(kp), _t(vp), _t(lens),
                                   softcap=softcap)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_k), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_r), rtol=3e-5, atol=3e-5)


def test_paged_attention_raw_stats_match_pallas_kernel():
    """(m, l, acc, page_m, page_l), a fully-masked row and page included."""
    q, kp, vp, lens = _attn_inputs(3, 3, 8, 2, 64, 64, 5, 16)
    lens[2] = 0
    lens[0, 3] = 0
    out_j = j_pa_ops.paged_attention_local_stats(
        *[jnp.asarray(x) for x in (q, kp, vp, lens)], interpret=True,
        return_page_stats=True)
    out_t = t_pa_ops.paged_attention_raw(_t(q), _t(kp), _t(vp), _t(lens),
                                         return_page_stats=True)
    for a, t in zip(out_j, out_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=3e-5, atol=3e-5)
    assert (out_t[3][0, 3] == -1e30).all() and (out_t[4][0, 3] == 0).all()


def test_paged_attention_bf16():
    import ml_dtypes
    q, kp, vp, lens = _attn_inputs(0, 2, 8, 2, 64, 64, 4, 16)
    lens[:] = 16
    kb, vb = kp.astype(ml_dtypes.bfloat16), vp.astype(ml_dtypes.bfloat16)
    qb = q.astype(ml_dtypes.bfloat16)
    o_k = j_pa_ops.paged_attention(jnp.asarray(qb), jnp.asarray(kb),
                                   jnp.asarray(vb), jnp.asarray(lens),
                                   interpret=True)
    # the port's decode feeds the kernel f32 queries over bf16 pages
    from repro_torch.convert import params_from_jax
    tb = params_from_jax({"k": kb, "v": vb, "q": qb}, device="cpu")
    o_t = t_pa_ops.paged_attention(tb["q"].float(), tb["k"], tb["v"], _t(lens))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_k, np.float32),
                               rtol=3e-2, atol=3e-2)


def _cluster_shares(p):
    """Page ranges of the C = min(P, 8) cluster ranks, split as
    ``csrc/paged_attn.cu`` splits them: the first P % C ranks one more."""
    c = min(p, 8)
    share, extra = divmod(p, c)
    starts = [r * share + min(r, extra) for r in range(c)]
    return [(lo, lo + share + (r < extra)) for r, lo in enumerate(starts)]


def _cluster_combine(parts):
    """Rank 0's merge of the ranks' (m_r, l_r, acc_r), in rank order:
    m = max m_r, w_r = exp(m_r - m), l = sum l_r w_r, acc = sum acc_r w_r."""
    m = torch.full_like(parts[0][0], -1e30)
    for m_r, _, _ in parts:
        m = torch.maximum(m, m_r)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for m_r, l_r, acc_r in parts:
        w = torch.exp(m_r - m)
        l = l + l_r * w
        acc = acc + acc_r * w
    return m, l, acc


@pytest.mark.parametrize("p", [1, 5, 13, 16])
def test_paged_attention_cluster_split_matches_plain_and_pallas(p):
    """The kernel's arithmetic: the plain version on each cluster rank's
    share of the pages, merged by the cluster combine, equals the plain
    version over all pages and the Pallas kernel, in float32 within
    1e-4 + 1e-4*|ref|; an all-masked share adds exactly 0 and an all-masked
    row gives m = -1e30, l = 0, acc = 0, with no NaN anywhere."""
    from repro_torch.kernels.paged_attn.ref import paged_attention_raw_ref
    b, h, hkv, d, t = 3, 8, 2, 32, 16
    q, kp, vp, lens = _attn_inputs(100 + p, b, h, hkv, d, d, p, t)
    shares = _cluster_shares(p)
    assert shares[0][0] == 0 and shares[-1][1] == p
    if len(shares) > 1:                     # row 0: rank 1's pages all masked
        lo, hi = shares[1]
        lens[0, lo:hi] = 0
    lens[2] = 0                             # an all-masked row
    tq, tk, tv, tl = _t(q), _t(kp), _t(vp), _t(lens)
    parts, pages = [], []
    for lo, hi in shares:
        m_r, l_r, acc_r, pm_r, pl_r = paged_attention_raw_ref(
            tq, tk[:, lo:hi].contiguous(), tv[:, lo:hi].contiguous(),
            tl[:, lo:hi].contiguous(), scale=d ** -0.5)
        parts.append((m_r, l_r, acc_r))
        pages.append((pm_r, pl_r))
    merged = (*_cluster_combine(parts), torch.cat([x[0] for x in pages], dim=1),
              torch.cat([x[1] for x in pages], dim=1))
    whole = paged_attention_raw_ref(tq, tk, tv, tl, scale=d ** -0.5)
    pallas = j_pa_ops.paged_attention_local_stats(
        *[jnp.asarray(x) for x in (q, kp, vp, lens)], interpret=True,
        return_page_stats=True)
    for name, a, w, j in zip(("m", "l", "acc", "page_m", "page_l"), merged,
                             whole, pallas):
        assert not torch.isnan(a).any(), name
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    m, l, acc = merged[:3]
    assert (m[2] == -1e30).all() and (l[2] == 0).all() and (acc[2] == 0).all()
    if len(shares) > 1:   # the masked share's rank contributes exactly 0
        rest = _cluster_combine([x for r, x in enumerate(parts) if r != 1])
        for a, r in zip(merged[:3], rest):
            assert torch.equal(a[0], r[0])


def test_page_mass_matches_reference():
    """Head-averaged per-page mass within 1e-6; masked pages exactly 0."""
    q, kp, vp, lens = _attn_inputs(11, 2, 8, 2, 32, 32, 6, 8)
    lens[1, 2] = 0
    args = [jnp.asarray(x) for x in (q, kp, vp, lens)]
    _, mass_k = j_pa_ops.paged_attention(*args, interpret=True, return_mass=True)
    mass_r = j_pa_ref.page_mass_ref(args[0], args[1], args[3])
    _, mass_t = t_pa_ops.paged_attention(_t(q), _t(kp), _t(vp), _t(lens),
                                         return_mass=True)
    np.testing.assert_allclose(mass_t.numpy(), np.asarray(mass_k), atol=1e-6)
    np.testing.assert_allclose(mass_t.numpy(), np.asarray(mass_r), atol=1e-6)
    assert (mass_t.numpy()[lens == 0] == 0).all()
    np.testing.assert_allclose(mass_t.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("theta", [0, 3, 20])
def test_ops_sketch_update_matches_core_bitwise(theta):
    """The kernel-path verb against the reference's core sketch_update, over
    several blocks and an epoch clear: state and newly_hot bitwise."""
    sp = jsk.SketchParams(width=1 << 12, depth=2)
    st_j = jsk.sketch_init(sp)
    st_t = tsk.sketch_init(tsk.SketchParams(width=1 << 12, depth=2),
                           _t(st_j.seeds), device="cpu")
    rng = np.random.default_rng(theta)
    for block in range(4):
        ids = np.concatenate([np.full(40, 77), rng.integers(-1, 4000, 216)]
                             ).astype(np.int32)
        st_j, hot_j = jsk.sketch_update(st_j, jnp.asarray(ids), jnp.int32(theta), sp)
        st_t, hot_t = t_np_ops.sketch_update(
            st_t, _t(ids), torch.tensor(theta, dtype=torch.int32),
            tsk.SketchParams(width=1 << 12, depth=2))
        np.testing.assert_array_equal(hot_t.numpy(), np.asarray(hot_j))
        for name, a, t in zip(jsk.SketchState._fields, st_j, st_t):
            np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=name)
        if block == 1:
            st_j, st_t = jsk.sketch_clear(st_j), tsk.sketch_clear(st_t)


def test_kernel_wrappers_refuse_other_devices():
    """No silent fallback: tensors on a device without a kernel path raise.
    Meta tensors (the dry run's) have one: shape-only, meta outputs, no
    values and no launch (tests/test_torch_roofline.py holds it further)."""
    from repro_torch.kernels.dispatch import kernel_device
    q = torch.zeros((1, 2, 4), device="meta")
    kp = torch.zeros((1, 1, 2, 2, 4), device="meta")
    out = t_pa_ops.paged_attention_raw(q, kp, kp, torch.zeros((1, 1), dtype=torch.int32,
                                                              device="meta"))
    assert [t.device.type for t in out] == ["meta"] * 3

    class _On:                        # a tensor's device, on a type with no path
        device = torch.device("mps")
    with pytest.raises(ValueError, match="no kernel path"):
        kernel_device(_On(), _On())
    with pytest.raises(ValueError):   # mixed devices
        t_pa_ops.paged_attention_raw(torch.zeros((1, 2, 4)), kp, kp,
                                     torch.zeros((1, 1), dtype=torch.int32))
