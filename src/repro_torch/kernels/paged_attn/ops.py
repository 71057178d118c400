"""Paged decode attention: kernel wrapper, normalisation and page mass.

``paged_attention_raw`` launches a Hopper kernel (``csrc/paged_attn.cu``)
on CUDA tensors and runs the plain version on CPU tensors: the grouped
kernel for up to ``MAX_GROUP`` query heads per kv head, the head-tiled
kernel above that (MLA's latent attention, a group of 128 on deepseek-v3).
The normalisation ``acc / max(l, 1e-30)`` and :func:`page_mass` stay plain
torch, as they stay jnp around the reference's Pallas kernel.

For page slots split over ranks (``models/decode.py``'s sharded paged
decode) each rank runs :func:`paged_attention_local_stats` (the same kernel)
over its local slots, and :func:`combine_stats` merges the ranks' (m, l,
acc) with an all-reduce MAX of m and one SUM each of ``l * w`` and
``acc * w``; given the page partials it also returns each local page's
share of the global softmax mass, normalised by the same pair.  These are
collectives around the kernel, not a kernel.
"""
from __future__ import annotations

import torch

from repro_torch.dist.collectives import all_reduce
from repro_torch.kernels import _lib
from repro_torch.kernels.dispatch import counted, kernel_device, require
from repro_torch.kernels.paged_attn.ref import paged_attention_raw_ref

__all__ = ["paged_attention_raw", "paged_attention", "page_mass", "head_tiled",
           "paged_attention_local_stats", "combine_stats"]

SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block may use
MAX_GROUP = 8            # query heads per kv head the grouped kernel's registers hold
MAX_DV = 512             # value width: one column pair per consumer thread
MAX_TILED_DK = 576       # head-tiled kernel: q's lo parts held in registers (MLA's 576)


class LaunchCount:
    """A launch counter read and reset like a wrapper's own ``launches``."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


# launches of the head-tiled kernel alone (each also counts in
# ``paged_attention_raw.launches``, which counts every attention launch)
head_tiled = LaunchCount("paged_attention_head_tiled")


def _tma_rows(t: torch.Tensor, width: int) -> bool:
    """A base and row width the head-tiled kernel's float4 and TMA box
    copies take."""
    return t.data_ptr() % 16 == 0 and (width * t.element_size()) % 16 == 0


def _attn_flops(out, q, k_pages, v_pages, *args, **kwargs) -> float:
    """q.k and p.v over every token slot of every page: 2 B H P T (dk + dv)
    (the kernel's work at full pages; ``analysis._attn_decode_flops``'s
    2 * 2 * B * cached tokens * H * dh where dk = dv = dh)."""
    b, h, dk = q.shape
    _, p, t = k_pages.shape[:3]
    return 2.0 * b * h * p * t * (dk + v_pages.shape[-1])


@counted("paged_attn", _attn_flops)
def paged_attention_raw(q, k_pages, v_pages, page_lengths, *, scale=None,
                        softcap: float = 0.0, return_page_stats: bool = False):
    """Unnormalised flash-decode stats (m, l, acc) [+ (page_m, page_l)].

    q (B,H,dk) f32; k_pages (B,P,T,Hkv,dk), v_pages (B,P,T,Hkv,dv), both
    bf16 or both f32; page_lengths (B,P) int32, 0 = invalid page.  Meta
    inputs give meta outputs of those shapes and launch nothing.
    """
    b, h, dk = q.shape
    _, p, t, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    scale = (dk ** -0.5) if scale is None else float(scale)
    kind = kernel_device(q, k_pages, v_pages, page_lengths)
    if kind == "cpu":
        out = paged_attention_raw_ref(q, k_pages, v_pages, page_lengths,
                                      scale=scale, softcap=softcap)
        return out if return_page_stats else out[:3]
    if kind == "meta":
        f32 = dict(dtype=torch.float32, device=q.device)
        out = (torch.empty((b, h, 1), **f32), torch.empty((b, h, 1), **f32),
               torch.empty((b, h, dv), **f32))
        if return_page_stats:
            out += (torch.empty((b, p, h), **f32), torch.empty((b, p, h), **f32))
        return out
    require(q, "q", torch.float32, (b, h, dk))
    if k_pages.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"k_pages: dtype {k_pages.dtype}, kernel takes bf16 or f32")
    require(k_pages, "k_pages", k_pages.dtype, (b, p, t, hkv, dk))
    require(v_pages, "v_pages", k_pages.dtype, (b, p, t, hkv, dv))
    require(page_lengths, "page_lengths", torch.int32, (b, p))
    if dv > MAX_DV:
        raise ValueError(f"kernel takes dv <= {MAX_DV}, got {dv}")
    tiled = h // hkv > MAX_GROUP
    if tiled and not (_tma_rows(q, dk) and _tma_rows(k_pages, dk)
                      and _tma_rows(v_pages, dv)):
        raise ValueError(f"the head-tiled kernel (a group of {h // hkv}) takes "
                         "16-byte aligned q and pages of 16-byte K and V rows")
    if tiled and dk > MAX_TILED_DK:
        raise ValueError(f"the head-tiled kernel (a group of {h // hkv}) takes "
                         f"dk <= {MAX_TILED_DK}, got {dk}")
    lib = _lib.lib()
    bf16 = int(k_pages.dtype == torch.bfloat16)
    smem = lib.paged_attn_smem_bytes(bf16, h // hkv, t, dk, dv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a page of {t} tokens needs {smem} B of shared memory "
                         f"(limit {SMEM_LIMIT})")
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, 1), **f32)
    l = torch.empty((b, h, 1), **f32)
    acc = torch.empty((b, h, dv), **f32)
    page_m = torch.empty((b, p, h), **f32) if return_page_stats else None
    page_l = torch.empty((b, p, h), **f32) if return_page_stats else None
    err = lib.paged_attn_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        page_m.data_ptr() if return_page_stats else None,
        page_l.data_ptr() if return_page_stats else None,
        b, h, hkv, p, t, dk, dv, bf16, scale, float(softcap),
        int(return_page_stats), _lib.stream_ptr(q.device))
    _lib.check(err, "paged_attn")
    paged_attention_raw.launches += 1
    if tiled:
        head_tiled.launches += 1
    return (m, l, acc, page_m, page_l) if return_page_stats else (m, l, acc)


paged_attention_raw.launches = 0


def paged_attention(q, k_pages, v_pages, page_lengths, *, scale=None,
                    softcap: float = 0.0, return_mass: bool = False):
    """Normalised paged decode attention; ``return_mass=True`` also returns
    the (B, P) head-averaged share of the step's softmax mass per page."""
    if not return_mass:
        m, l, acc = paged_attention_raw(q, k_pages, v_pages, page_lengths,
                                        scale=scale, softcap=softcap)
        return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    m, l, acc, page_m, page_l = paged_attention_raw(
        q, k_pages, v_pages, page_lengths, scale=scale, softcap=softcap,
        return_page_stats=True)
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out, page_mass(m, l, page_m, page_l)


def page_mass(m, l, page_m, page_l):
    """Normalise page-local partials into per-page softmax mass: (B, P) f32,
    valid pages sum to 1, fully-masked pages contribute exactly 0."""
    m_glob = m.transpose(1, 2)                            # (B, 1, H)
    l_glob = l.transpose(1, 2)
    mass = page_l * torch.exp(page_m - m_glob) / torch.clamp_min(l_glob, 1e-30)
    return mass.mean(dim=-1)


def paged_attention_local_stats(q, k_pages, v_pages, page_lengths, *, scale=None,
                                softcap: float = 0.0, return_page_stats: bool = False):
    """The raw flash-decode stats of a rank's local page slots
    (:func:`paged_attention_raw`), for :func:`combine_stats`."""
    return paged_attention_raw(q, k_pages, v_pages, page_lengths, scale=scale,
                               softcap=softcap, return_page_stats=return_page_stats)


def combine_stats(m, l, acc, group, page_m=None, page_l=None):
    """The flash-decoding softmax combine of every rank's (m, l, acc) over
    ``group`` -> the normalised output (B, H, dv) f32; with the page
    partials (each rank's (B, P_local, H)) also the (B, P_local) share of
    the GLOBAL attention mass each local page holds."""
    m_glob = all_reduce(m.clone(), group, torch.distributed.ReduceOp.MAX)
    w = torch.exp(m - m_glob)
    l_glob = all_reduce(l * w, group)
    acc_glob = all_reduce(acc * w, group)
    out = acc_glob / torch.clamp_min(l_glob, 1e-30)
    if page_m is None:
        return out
    return out, page_mass(m_glob, l_glob, page_m, page_l)
