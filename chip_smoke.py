#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # one card

Phases, one summary line each:
  1. device   — the card's name and power limit, then the kernels' build;
  2. kernels  — each Hopper kernel against its plain PyTorch version on the
                card, at the main path's shapes and at edge shapes (integer
                outputs bitwise; attention within ATOL + RTOL*|ref| in
                float32, TF32 off, for every cluster split of the pages),
                with its device time per call (CUDA events, median of
                LAUNCHES graph replays, see time_ms; attention and its SDPA
                yardstick cold in L2, rotating over COLD_SETS input sets,
                with the warm figure printed beside), its bound, the plain
                version's and one library call's device time, and the host's
                wall time per eager call; the sketch update and histogram
                also at D=2, S=16 and W=16K and the paper's W=512K, cold
                (rotating over SKETCH_SETS input sets) and warm, the
                histogram also on rows shaped like the main path's;
  3. main     — ServeEngine on llama3.2-3b at full width (random weights
                from a seed) serving a batch of 4 random 1024-token prompts
                for 64 greedy tokens through the NeoMem loop; every kernel
                must have launched, logits finite, page mass summing to 1,
                migration and flush bytes > 0, and the sketch must replay
                bitwise through the plain CPU sketch; then 8 more decode
                steps under torch.profiler give the device's busy share,
                its launches per step, the kernels that fill it and paged
                attention's share, and
                decode steps alternate swiglu's activation between F.silu
                and the reference's op-by-op formula to time the two on
                one host.
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}.  Any failure raises (exit != 0)
and prints no result; with no CUDA device the script exits 2.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LAUNCHES = 100          # timed calls per measurement (median reported)
SPIN_CYCLES = 1 << 26   # card clock cycles the timed calls queue behind
ATOL, RTOL = 1e-4, 1e-4  # attention kernel vs plain version, float32
COLD_SETS = 6           # attention input sets rotated through (101 MB of K/V > L2)
SKETCH_SETS = 24        # sketch input sets rotated through (151 MB at W=512K > L2)
PAPER_W = 1 << 19       # the paper's sketch width (Table III: W=512K, D=2)
# datasheet memory bandwidth (bytes/s) and float32 non-tensor peak (flop/s)
CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


def card_rates(name: str) -> tuple[float, float]:
    for key, bw, f32 in CARDS:
        if key in name:
            return bw, f32
    raise RuntimeError(f"no datasheet rates for card {name!r}")


def _graph(fn):
    """``fn`` captured once in a CUDA graph (after warm-up on a side
    stream); returns the graph's replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def time_ms(fn, n: int = LAUNCHES, graph: bool = True) -> float:
    """Median device time of one call of ``fn``, by CUDA events.

    The call is captured once in a CUDA graph; ``n`` replays, each between
    its own event pair, are queued behind a spin kernel, so the card runs
    them back to back and a pair brackets the call's device work, not the
    host's Python and launch path.  ``fn`` may be a list of calls over
    distinct inputs: one graph each, replayed round-robin, so that with
    more input bytes than the 50 MB L2 each call finds its inputs cold, as
    the main path's layers do.  ``graph=False`` queues ``fn`` itself, for a
    call that synchronises with the host and so cannot be captured (its
    time then includes the host's)."""
    import torch
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    runs = [_graph(f) for f in fns] if graph else fns
    for run in runs:
        run()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for i, (s, e) in enumerate(ev):
        s.record()
        runs[i % len(runs)]()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def host_ms(fn, n: int = LAUNCHES) -> float:
    """Wall time per eager call of ``fn`` over ``n`` calls back to back:
    the host's Python and launch path wherever it is slower than the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def bound_ms(nbytes: float, nops: float, rates) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rates[0] * 1e3, nops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(outs, refs) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, refs))


# -- phase 2: kernels against their plain versions -----------------------------

def check_attention(torch, pa_ops, pa_ref, rates, gen):
    """Edge shapes, then the main path's shape (timed)."""
    def case(b, h, hkv, dk, dv, p, t, dtype, lens, softcap=0.0):
        q = torch.randn((b, h, dk), generator=gen, device="cuda")
        kp = torch.randn((b, p, t, hkv, dk), generator=gen, device="cuda").to(dtype)
        vp = torch.randn((b, p, t, hkv, dv), generator=gen, device="cuda").to(dtype)
        lens = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        out = pa_ops.paged_attention_raw(q, kp, vp, lens, softcap=softcap,
                                         return_page_stats=True)
        ref = pa_ref.paged_attention_raw_ref(q, kp, vp, lens,
                                             scale=dk ** -0.5, softcap=softcap)
        torch.cuda.synchronize()
        for name, a, r in zip(("m", "l", "acc", "page_m", "page_l"), out, ref):
            bad = ~((a - r).abs() <= ATOL + RTOL * r.abs())   # NaN is bad too
            if bool(bad.any()):
                raise AssertionError(
                    f"paged_attn {name} differs at {(b, h, hkv, dk, dv, p, t, dtype)}:"
                    f" max err {float((a - r).abs().max())}")
        mass = pa_ops.page_mass(*[out[i] for i in (0, 1, 3, 4)])
        valid_rows = (lens > 0).any(dim=1)
        sums = mass.sum(dim=1)[valid_rows]
        if not bool(((sums - 1).abs() < 1e-4).all()):
            raise AssertionError(f"page mass sums {sums.tolist()} != 1")
        if not bool((mass[lens == 0] == 0).all()):
            raise AssertionError("a masked page carries mass")
        return q, kp, vp, lens, out, ref

    rng = np.random.default_rng(0)
    bf16, f32 = torch.bfloat16, torch.float32
    edge = rng.integers(0, 17, (3, 5))
    edge[2] = 0                                  # a fully masked row
    case(3, 8, 2, 64, 64, 5, 16, f32, edge)      # P=5: cluster of 5, one page each
    case(1, 4, 4, 32, 32, 8, 32, f32, rng.integers(1, 33, (1, 8)), softcap=30.0)
    case(3, 8, 1, 72, 64, 2, 8, f32, rng.integers(0, 9, (3, 2)))  # dk != dv
    case(2, 24, 8, 72, 64, 4, 64, bf16, rng.integers(0, 65, (2, 4)))  # ... in bf16
    case(2, 8, 2, 64, 64, 4, 16, bf16, np.full((2, 4), 16))           # full pages
    case(2, 24, 8, 128, 128, 1, 64, bf16, [[64], [0]])          # P=1
    lens = rng.integers(0, 65, (3, 13))
    lens[1] = 0                                   # P=13: shares 2,2,2,2,2,1,1,1
    case(3, 24, 8, 128, 128, 13, 64, bf16, lens)
    # P=16: rank 3 (pages 6, 7) all masked in row 0; pages of 1 token in row 1
    lens = np.full((3, 16), 64)
    lens[0, 6:8] = 0
    lens[1, ::2] = 1
    lens[2, 1::3] = 1
    case(3, 24, 8, 128, 128, 16, 64, bf16, lens)
    case(2, 24, 8, 128, 128, 16, 64, f32, rng.integers(0, 65, (2, 16)))  # f32 K/V
    case(2, 8, 2, 36, 36, 6, 16, bf16, rng.integers(0, 17, (2, 6)))  # 72 B rows: plain loads
    case(4, 24, 8, 128, 128, 64, 64, bf16, rng.integers(0, 65, (4, 64)))  # P=64: max_seq 4096
    # main path: llama3.2-3b decode, B=4, 16 ring slots of 64 tokens, the
    # current slot part-filled
    b, h, hkv, d, p, t = 4, 24, 8, 128, 16, 64
    lens = np.full((b, p), t)
    lens[:, 5] = 37
    main = [case(b, h, hkv, d, d, p, t, bf16, lens) for _ in range(COLD_SETS)]
    err = max(max_err(out, ref) for *_, out, ref in main)
    sets = [x[:4] for x in main]
    q, kp, vp, lt = sets[0]
    calls = [lambda x=x: pa_ops.paged_attention_raw(*x, return_page_stats=True)
             for x in sets]
    warm, cold, host = time_ms(calls[0]), time_ms(calls), host_ms(calls[0])
    plain = time_ms(lambda: pa_ref.paged_attention_raw_ref(q, kp, vp, lt,
                                                           scale=d ** -0.5))

    # library yardstick: SDPA over the gathered pages with a token mask
    def sdpa_call(q, kp, vp, lt):
        qs = q.to(torch.bfloat16)[:, :, None, :]
        ks, vs = (x.repeat_interleave(h // hkv, dim=3).permute(0, 3, 1, 2, 4)
                  .reshape(b, h, p * t, d) for x in (kp, vp))
        mask = (torch.arange(t, device="cuda")[None, None] < lt[:, :, None]
                ).reshape(b, 1, 1, p * t)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return lambda: sdpa(qs, ks, vs, attn_mask=mask)
    lib_calls = [sdpa_call(*x) for x in sets]
    lib_warm, lib_cold = time_ms(lib_calls[0]), time_ms(lib_calls)
    kv_mb = COLD_SETS * kp.numel() * kp.element_size() * 2 / 1e6
    print(f"kernel paged_attn: device {cold:.4f} ms cold ({COLD_SETS} input sets, "
          f"{kv_mb:.1f} MB of K/V, round-robin), {warm:.4f} ms warm (one set, L2-"
          f"resident); SDPA {lib_cold:.4f} ms cold, {lib_warm:.4f} ms warm")
    # what the time is made of: a graph replay of one tiny kernel (the timing
    # floor), and the call with every page masked (launch, cluster set-up and
    # combine, no K/V bytes)
    tiny = torch.zeros(1, device="cuda")
    masked = torch.zeros_like(lt)
    floor = time_ms(tiny.zero_)
    empty = time_ms(lambda: pa_ops.paged_attention_raw(q, kp, vp, masked,
                                                       return_page_stats=True))
    print(f"kernel paged_attn: timing floor {floor:.4f} ms (one tiny kernel per "
          f"graph replay); every page masked {empty:.4f} ms")
    n_tok = int(lens.sum())
    nbytes = (q.numel() * 4 + n_tok * hkv * 2 * d * 2 + lt.numel() * 4
              + b * h * (2 + d) * 4 + 2 * b * p * h * 4)
    nops = n_tok * h * 4 * d
    bms, by = bound_ms(nbytes, nops, rates)
    return dict(name="paged_attn", route="cuda",
                source="src/repro_torch/csrc/paged_attn.cu",
                replaces="src/repro/kernels/paged_attn/paged_attn.py:34",
                max_abs_err=err, ms=cold, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib_cold, host_ms=host)


def check_sketch(torch, np_ops, np_ref, hist_ops, hist_ref, sk, rates, gen):
    """Update, mark and histogram kernels: edge cases, then the main path's
    shapes (timed) and the paper's W=512K (timed cold)."""
    cmax = sk.SketchParams().counter_max
    edges = torch.as_tensor(sk.hist_edges(), device="cuda")

    def state(d, w, kind="random", offset=0):
        """A (D, W) sketch on the card whose current epoch is 7.  ``kind``:
        random (counters 0..49), near_max (cmax-3..cmax), at_max (all cmax),
        zero (all 0), mixed (tags 6 or 7), stale (every tag 6), main (as
        the main path's row 0 looks: 94% of counters 0, the rest 1..8, a
        tenth of the tags stale).  ``offset`` > 0 shifts every plane off
        16-byte alignment."""
        def plane(dtype, fill):
            return torch.empty((d * w + offset,), dtype=dtype, device="cuda"
                               )[offset:].view(d, w).copy_(fill)
        counts = torch.randint(0, 50, (d, w), generator=gen, device="cuda",
                               dtype=torch.int32)
        tags = torch.full((d, w), 7, dtype=torch.uint8, device="cuda")
        if kind == "near_max":
            counts = counts % 4 + (cmax - 3)
        elif kind == "at_max":
            counts.fill_(cmax)
        elif kind == "zero":
            counts.zero_()
        elif kind == "main":
            counts = torch.where(torch.rand((d, w), generator=gen, device="cuda")
                                 < 0.06, counts % 8 + 1, 0)
        if kind == "mixed":
            tags = torch.randint(6, 8, (d, w), generator=gen, device="cuda"
                                 ).to(torch.uint8)
        elif kind == "stale":
            tags.fill_(6)
        elif kind == "main":
            tags[torch.rand((d, w), generator=gen, device="cuda") < 0.1] = 6
        hot = torch.rand((d, w), generator=gen, device="cuda") < 0.1
        seeds = torch.randint(0, w, (d, sk.PAGE_ID_BITS), generator=gen,
                              device="cuda", dtype=torch.int32)
        cur = torch.tensor(7, dtype=torch.uint8, device="cuda")
        return (plane(torch.int32, counts), plane(torch.uint8, tags),
                plane(torch.bool, hot), seeds, cur)

    def ids_for(s, hi, pad=True, dup=True):
        ids = torch.randint(-1 if pad else 0, hi, (s,), generator=gen,
                            device="cuda", dtype=torch.int32)
        if dup:
            ids[: s // 4] = ids[0].clamp_min(3)
        return ids

    def run(d, w, s, kind="random", ids=None, offset=0):
        counts, epochs, hot, seeds, cur = state(d, w, kind, offset)
        ids = ids_for(s, 1 << 18) if ids is None else ids
        out = np_ops.sketch_update_kernel(counts, epochs, hot, ids, seeds, cur, cmax)
        ref = np_ref.update_ref(counts, epochs, hot, ids, seeds, cur, cmax)
        is_hot = torch.rand((s,), generator=gen, device="cuda") < 0.3
        mk = np_ops.sketch_mark_hot_kernel(hot, ids, is_hot, seeds)
        mr = np_ref.mark_hot_ref(hot, ids, is_hot, seeds)
        hk = hist_ops.hist_kernel(counts[0], epochs[0], cur, edges)
        hr = hist_ref.hist_ref(counts[0], epochs[0], cur, edges)
        torch.cuda.synchronize()
        for name, a, r in zip(("counts", "epochs", "est", "hot_before", "mark",
                               "hist"), (*out, mk, hk), (*ref, mr, hr)):
            if a.dtype != r.dtype or not torch.equal(a, r):
                raise AssertionError(f"{name} differs at D={d} W={w} S={s} "
                                     f"{kind} offset={offset}")
        return (counts, epochs, hot, ids, seeds, cur, is_hot,
                max_err((*out, mk, hk), (*ref, mr, hr)))

    def mark_case(d, w, s, offset=0):
        """Mark alone (the update needs a power-of-two width): seeds below
        512 keep every hash inside a lane; ``offset`` shifts the plane off
        16-byte alignment.  The old plane must come back unchanged."""
        buf = torch.rand((d * w + offset,), generator=gen, device="cuda") < 0.1
        hot = buf[offset:].view(d, w)
        seeds = torch.randint(0, 512, (d, sk.PAGE_ID_BITS), generator=gen,
                              device="cuda", dtype=torch.int32)
        ids = ids_for(s, 1 << 18)
        is_hot = torch.rand((s,), generator=gen, device="cuda") < 0.5
        before = hot.clone()
        mk = np_ops.sketch_mark_hot_kernel(hot, ids, is_hot, seeds)
        mr = np_ref.mark_hot_ref(hot, ids, is_hot, seeds)
        torch.cuda.synchronize()
        if not (torch.equal(mk, mr) and torch.equal(hot, before)):
            raise AssertionError(f"mark differs at D={d} W={w} S={s} offset={offset}")

    mark_case(3, 1000, 64)                   # plane of 3000 B: a scalar tail
    mark_case(2, 1 << 14, 16, offset=1)      # unaligned plane: byte copies
    run(2, 4096, 256)                        # padding + duplicates
    run(3, 1024, 512, "mixed")               # W below one update segment
    run(2, 4096, 1)                          # one id
    run(2, 4096, 64, ids=torch.full((64,), -1, dtype=torch.int32, device="cuda"))
    run(2, 4096, 1024, "near_max")           # duplicates saturate at counter_max
    run(2, 1 << 14, 1024, "near_max")        # the same over several segments a lane
    run(2, 4096, 256, "at_max")              # every counter at counter_max
    run(2, 4096, 256, "stale")               # a fully stale sketch reads 0
    run(2, 4096, 256, "zero")                # an all-zero row
    run(2, 4096, 256, offset=1)              # planes off 16-byte alignment
    run(2, PAPER_W, 1024, "main")            # the paper's width
    # the ops-level verb against the core's plain sketch_update
    sp = sk.SketchParams(width=1 << 12)
    st = sk.sketch_init(sp, device="cuda")
    for theta in (0, 2):
        ids = ids_for(256, 4000)
        st_k, nh_k = np_ops.sketch_update(st, ids, torch.tensor(theta, device="cuda"), sp)
        st_c, nh_c = sk.sketch_update(st, ids, torch.tensor(theta, device="cuda"), sp)
        for a, r in zip((*st_k, nh_k), (*st_c, nh_c)):
            if not torch.equal(a, r):
                raise AssertionError("ops.sketch_update != core.sketch_update")
        st = st_k
    if not torch.equal(hist_ops.sketch_histogram(st, sp), sk.sketch_histogram(st, sp)):
        raise AssertionError("ops.sketch_histogram != core.sketch_histogram")

    # main path: D=2, W=16384, one ring's 16 page ids per block
    d, w, s = 2, 1 << 14, 16
    counts, epochs, hot, ids, seeds, cur, is_hot, err = run(d, w, s)
    rows = []
    args = (counts, epochs, hot, ids, seeds, cur, cmax)
    lane = torch.arange(d, device="cuda")[:, None].expand(d, s)
    h_idx = sk.h3_hash(torch.where(ids >= 0, ids, 0), seeds).long()
    acc_into = counts.clone()
    ones = (ids >= 0).to(torch.int32).expand(d, s)
    bms, by = bound_ms(*update_work(d, w, s, seeds), rates)
    launch = lambda: np_ops.sketch_update_kernel(*args)  # noqa: E731
    rows.append(dict(
        name="neoprof_update", route="cuda",
        source="src/repro_torch/csrc/neoprof_update.cu",
        replaces="src/repro/kernels/neoprof_update/neoprof_update.py:45",
        max_abs_err=err, ms=time_ms(launch), host_ms=host_ms(launch),
        plain_ms=time_ms(lambda: np_ref.update_ref(*args)), bound_ms=bms,
        bound_by=by,
        library_ms=time_ms(lambda: acc_into.index_put_((lane, h_idx), ones,
                                                       accumulate=True))))
    hot_into = hot.clone()
    sel = is_hot & (ids >= 0)
    mark_at = (lane[:, sel], h_idx[:, sel])
    true = torch.tensor(True, device="cuda")
    nbytes = d * w * 2 + s * 5 + seeds.numel() * 4
    bms, by = bound_ms(nbytes, d * s * 32, rates)
    launch = lambda: np_ops.sketch_mark_hot_kernel(hot, ids, is_hot, seeds)  # noqa: E731
    # the library call for the same (out-of-place) function is index_put;
    # the in-place index_put_ skips the plane's copy and is shown only here
    in_place = time_ms(lambda: hot_into.index_put_(mark_at, true))
    print(f"kernel neoprof_mark: in-place index_put_ {in_place:.4f} ms "
          "(a different function: no copy of the plane)")
    rows.append(dict(
        name="neoprof_mark", route="cuda",
        source="src/repro_torch/csrc/neoprof_update.cu",
        replaces="src/repro/kernels/neoprof_update/neoprof_update.py:93",
        max_abs_err=err, ms=time_ms(launch), host_ms=host_ms(launch),
        plain_ms=time_ms(lambda: np_ref.mark_hot_ref(hot, ids, is_hot, seeds)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: hot.index_put(mark_at, true))))
    bms, by = bound_ms(*hist_work(w, edges), rates)
    launch = lambda: hist_ops.hist_kernel(counts[0], epochs[0], cur, edges)  # noqa: E731
    rows.append(dict(
        name="cms_hist", route="cuda", source="src/repro_torch/csrc/cms_hist.cu",
        replaces="src/repro/kernels/cms_hist/cms_hist.py:22", max_abs_err=err,
        ms=time_ms(launch), host_ms=host_ms(launch),
        plain_ms=time_ms(lambda: hist_ref.hist_ref(counts[0], epochs[0], cur, edges)),
        bound_ms=bms, bound_by=by,
        library_ms=hist_library_ms(torch, counts[0], epochs[0], cur, edges)))
    floor = time_ms(torch.zeros(1, device="cuda").zero_)
    print(f"kernel sketch: timing floor {floor:.4f} ms (one tiny kernel per graph replay)")

    def timed(w, d=2, s=16):
        """Update and histogram at D=2, width ``w``, S=16, cold in L2
        (rotating over SKETCH_SETS input sets) and warm (one set), beside
        their bounds and library calls; the histogram also on rows shaped
        like the main path's."""
        sets = []
        for _ in range(SKETCH_SETS):
            c, e, h, sd, cu = state(d, w)
            sets.append((c, e, h, ids_for(s, 1 << 18), sd, cu))
        mb = SKETCH_SETS * d * w * (4 + 1 + 1) / 1e6
        upd = [lambda x=x: np_ops.sketch_update_kernel(*x, cmax) for x in sets]
        counts, epochs, hot, ids, seeds, cur = sets[0]
        lane = torch.arange(d, device="cuda")[:, None].expand(d, s)
        h_idx = sk.h3_hash(torch.where(ids >= 0, ids, 0), seeds).long()
        ones = (ids >= 0).to(torch.int32).expand(d, s)
        acc_into = counts.clone()
        lib = time_ms(lambda: acc_into.index_put_((lane, h_idx), ones, accumulate=True))
        bms, by = bound_ms(*update_work(d, w, s, seeds), rates)
        print(f"kernel neoprof_update at D={d} W={w} S={s}: device "
              f"{time_ms(upd):.4f} ms cold ({SKETCH_SETS} input sets, {mb:.1f} MB, "
              f"round-robin), {time_ms(upd[0]):.4f} ms warm; bound {bms:.6f} ms "
              f"by {by}; index_put_ accumulate {lib:.4f} ms warm")
        hist = [lambda x=x: hist_ops.hist_kernel(x[0][0], x[1][0], x[5], edges)
                for x in sets]
        main_like = [state(1, w, "main") for _ in range(SKETCH_SETS)]
        hist_main = [lambda x=x: hist_ops.hist_kernel(x[0][0], x[1][0], x[4], edges)
                     for x in main_like]
        bms, by = bound_ms(*hist_work(w, edges), rates)
        lib = hist_library_ms(torch, counts[0], epochs[0], cur, edges)
        print(f"kernel cms_hist at W={w}: device {time_ms(hist):.4f} ms cold, "
              f"{time_ms(hist[0]):.4f} ms warm (counters uniform in 0..49); "
              f"main-path-like rows (94% zero, 10% of tags stale) "
              f"{time_ms(hist_main):.4f} ms cold, {time_ms(hist_main[0]):.4f} ms "
              f"warm; bound {bms:.6f} ms by {by}; bucketize + bincount {lib:.4f} ms")

    timed(1 << 14)
    timed(PAPER_W)
    return rows


def update_work(d, w, s, seeds):
    """Bytes and integer operations of one update call: every counter and
    tag read and written once, the hot bit read and est/hot_before written
    per (lane, id), the ids and seeds read; ~40 operations per (lane, id)."""
    return (d * w * (4 + 1) * 2 + d * s * (1 + 4 + 4) + s * 4 + seeds.numel() * 4,
            d * s * 40)


def hist_work(w, edges):
    """Bytes and operations of one histogram call: row 0's counters and tags
    read once, the edges read and 64 bins written; ~8 operations a counter."""
    return w * (4 + 1) + edges.numel() * 4 + 64 * 4, w * 8


def hist_library_ms(torch, counts_row0, epochs_row0, cur, edges):
    """``bucketize`` + ``bincount`` on the live row, eager: ``bincount`` sizes
    its output from the input's max, read on the host."""
    live = torch.where(epochs_row0 == cur, counts_row0, 0)
    return time_ms(lambda: torch.bincount(
        torch.bucketize(live, edges, right=True) - 1, minlength=64), graph=False)


# -- phase 3: the main path at full width -----------------------------------------

def main_path(torch, counters):
    from repro_torch.configs.registry import get_config
    from repro_torch.core import sketch as sk
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"main: llama3.2-3b full width, {n_params / 1e9:.3f} B params bf16 "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(cfg, params, ServeConfig(
        max_seq=4096, paged=True, page_t=64, hot_slots=16, migration_interval=8))
    h = eng.daemon["kv"]
    blocks = []          # (ids, theta, epoch) of every block the sketch took
    observe = h.mem.observe

    def recording(state, pages, **kw):
        blocks.append((pages.cpu(), int(state.prof.theta),
                       int(state.prof.sketch.cur_epoch)))
        return observe(state, pages, **kw)
    h.mem.observe = recording

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 1024))
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    tok = eng.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(63):
        tok = eng.step(tok)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    tokens = np.stack(out, axis=1)
    assert tokens.shape == (4, 64) and (tokens >= 0).all() and (tokens < cfg.vocab).all()
    stats = eng.tier_stats()["kv"]
    logits = eng._advance(torch.as_tensor(tok, device="cuda")[:, None])
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    sums = eng._last_kv_mass.sum(dim=1)
    if not bool(((sums - 1).abs() < 1e-4).all()):
        raise AssertionError(f"page mass sums {sums.tolist()} != 1")
    if not (stats["migration_bytes"] > 0 and stats["flush_bytes"] > 0):
        raise AssertionError(f"no bytes moved: {stats}")
    # replay the recorded blocks through the plain sketch on the CPU
    sp = h.mem.pp.sketch
    dev_sk = h.state.prof.sketch
    st = sk.sketch_init(sp, dev_sk.seeds.cpu(), device="cpu")
    for ids, theta, epoch in blocks:
        while int(st.cur_epoch) != epoch:
            st = sk.sketch_clear(st)
        st, _ = sk.sketch_update(st, ids, torch.tensor(theta, dtype=torch.int32), sp)
    while int(st.cur_epoch) != int(dev_sk.cur_epoch):
        st = sk.sketch_clear(st)
    for name in ("counts", "epochs", "hot", "n_seen"):
        if not torch.equal(getattr(st, name), getattr(dev_sk, name).cpu()):
            raise AssertionError(f"sketch replay: {name} differs")
    print(f"main: sketch replay of {len(blocks)} blocks bitwise equal")
    print(f"main: prefill {prefill_s:.3f} s for 4x1024 tokens; decode "
          f"{4 * 63 / decode_s:.2f} tokens/s, {1e3 * decode_s / 63:.2f} ms/step")
    print("main: kv tier_stats " + json.dumps(stats))
    print("main: launches " + json.dumps(launches))
    tok = profile_decode(torch, eng, tok)
    silu_ab(torch, eng, tok)
    return launches, dict(prefill_s=prefill_s, decode_tokens_per_s=4 * 63 / decode_s,
                          ms_per_step=1e3 * decode_s / 63)


def profile_decode(torch, eng, tok, steps: int = 8):
    """torch.profiler over ``steps`` decode steps: the device's busy share
    of the wall time and the kernels that fill it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = eng.step(tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side rows only (kernels, copies); the aten rows that launched
    # them carry the same time again
    dev = sorted(((getattr(e, key), e.key, e.count) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and getattr(e, key) > 0), reverse=True)
    busy_us = sum(t for t, _, _ in dev)
    launches = sum(count for _, _, count in dev)
    print(f"profile: {steps} decode steps, wall {wall_us / steps / 1e3:.2f} ms/step, "
          f"device busy {busy_us / steps / 1e3:.2f} ms/step "
          f"({100 * busy_us / wall_us:.1f}% of wall), "
          f"{launches / steps:.1f} device launches/step (kernels and copies)")
    for t, name, count in dev[:8]:
        print(f"profile:   {t / steps / 1e3:8.3f} ms/step  {count // steps:5d}/step  {name[:70]}")
    attn_us = sum(t for t, name, _ in dev if "paged_attn_kernel" in name)
    attn_n = sum(count for _, name, count in dev if "paged_attn_kernel" in name)
    print(f"profile: paged attention {attn_us / steps / 1e3:.3f} ms/step over "
          f"{attn_n / steps:.1f} launches/step, {100 * attn_us / busy_us:.1f}% of "
          "device busy time")
    return tok


def silu_ab(torch, eng, tok, steps: int = 8, rounds: int = 5):
    """Unprofiled decode ms/step with swiglu's activation as shipped
    (``F.silu``, one launch) and as the reference's formula written op by
    op (four launches), in ``2 * rounds`` pairs run A B B A on this host."""
    import torch.nn.functional as F
    shipped = F.silu

    def op_by_op(x):
        return x * (1 / (1 + torch.exp(-x)))

    times = {"F.silu": [], "op-by-op": []}
    try:
        for _ in range(rounds):
            for name in ("F.silu", "op-by-op", "op-by-op", "F.silu"):
                F.silu = shipped if name == "F.silu" else op_by_op
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    tok = eng.step(tok)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        F.silu = shipped
    wins = sum(a < b for a, b in zip(times["F.silu"], times["op-by-op"]))
    print("silu A/B: decode ms/step, median of {} runs of {} steps: {}; "
          "F.silu faster in {} of {} pairs".format(
              2 * rounds, steps, ", ".join(
                  f"{k} {statistics.median(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})"
                  for k, v in times.items()), wins, 2 * rounds))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import sketch as sk
        from repro_torch.kernels import _lib
        from repro_torch.kernels.cms_hist import ops as hist_ops, ref as hist_ref
        from repro_torch.kernels.neoprof_update import ops as np_ops, ref as np_ref
        from repro_torch.kernels.paged_attn import ops as pa_ops, ref as pa_ref
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    t0 = time.perf_counter()
    _lib.lib()
    print(f"PHASE device: {name} ({smi}); kernels built in "
          f"{time.perf_counter() - t0:.1f} s into {_lib.library_path().name}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_attention(torch, pa_ops, pa_ref, rates, gen)]
    rows += check_sketch(torch, np_ops, np_ref, hist_ops, hist_ref, sk, rates, gen)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g}, device "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms), "
              f"host {r['host_ms']:.4f} ms per eager call, on {smi}")
    print(f"PHASE kernels: all {len(rows)} match their plain versions "
          f"(integer outputs bitwise, attention within {ATOL}+{RTOL}*|ref|)")

    counters = (pa_ops.paged_attention_raw, np_ops.sketch_update_kernel,
                np_ops.sketch_mark_hot_kernel, hist_ops.hist_kernel)
    launches, e2e = main_path(torch, counters)
    print(f"PHASE main: ok, {e2e['decode_tokens_per_s']:.2f} decode tokens/s "
          f"on {smi}")
    by_name = {"paged_attn": "paged_attention_raw",
               "neoprof_update": "sketch_update_kernel",
               "neoprof_mark": "sketch_mark_hot_kernel",
               "cms_hist": "hist_kernel"}
    for r in rows:
        r["launches"] = launches[by_name[r["name"]]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
