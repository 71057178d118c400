"""Paged decode attention: kernel wrapper, normalisation and page mass.

``paged_attention_raw`` launches the Hopper kernel (``csrc/paged_attn.cu``)
on CUDA tensors and runs the plain version on CPU tensors.  The
normalisation ``acc / max(l, 1e-30)`` and :func:`page_mass` stay plain
torch, as they stay jnp around the reference's Pallas kernel.  The sharded
path's ``paged_attention_local_stats`` / ``combine_stats`` come with the
distribution layer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.dispatch import kernel_device, require
from repro_torch.kernels.paged_attn.ref import paged_attention_raw_ref

__all__ = ["paged_attention_raw", "paged_attention", "page_mass"]

SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block may use
MAX_GROUP = 8            # query heads per kv head the kernel's registers hold
MAX_DV = 512             # value width: one column pair per consumer thread


def paged_attention_raw(q, k_pages, v_pages, page_lengths, *, scale=None,
                        softcap: float = 0.0, return_page_stats: bool = False):
    """Unnormalised flash-decode stats (m, l, acc) [+ (page_m, page_l)].

    q (B,H,dk) f32; k_pages (B,P,T,Hkv,dk), v_pages (B,P,T,Hkv,dv), both
    bf16 or both f32; page_lengths (B,P) int32, 0 = invalid page.
    """
    b, h, dk = q.shape
    _, p, t, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    scale = (dk ** -0.5) if scale is None else float(scale)
    if kernel_device(q, k_pages, v_pages, page_lengths) == "cpu":
        out = paged_attention_raw_ref(q, k_pages, v_pages, page_lengths,
                                      scale=scale, softcap=softcap)
        return out if return_page_stats else out[:3]
    require(q, "q", torch.float32, (b, h, dk))
    if k_pages.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"k_pages: dtype {k_pages.dtype}, kernel takes bf16 or f32")
    require(k_pages, "k_pages", k_pages.dtype, (b, p, t, hkv, dk))
    require(v_pages, "v_pages", k_pages.dtype, (b, p, t, hkv, dv))
    require(page_lengths, "page_lengths", torch.int32, (b, p))
    if h // hkv > MAX_GROUP or dv > MAX_DV:
        raise ValueError(f"kernel takes <= {MAX_GROUP} query heads per kv head and "
                         f"dv <= {MAX_DV}, got {h // hkv} and {dv}")
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
