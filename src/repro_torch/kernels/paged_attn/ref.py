"""Plain PyTorch version of the paged flash-decode kernel.

Computes the same function as ``csrc/paged_attn.cu`` — the unnormalised
softmax stats (m, l, acc) over every valid token of every page, plus each
page's own (page_m, page_l) — in one pass over the gathered pages, in
float32.  It is the CPU path of :func:`..ops.paged_attention_raw` and the
yardstick the kernel is held to on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_raw_ref(q, k_pages, v_pages, page_lengths, *, scale=None,
                            softcap: float = 0.0):
    """-> (m (B,H,1), l (B,H,1), acc (B,H,dv), page_m (B,P,H), page_l (B,P,H)).

    A fully-masked row reports m = -1e30, l = 0, acc = 0; a fully-masked
    page reports page_m = -1e30, page_l = 0.
    """
    b, h, dk = q.shape
    _, p, t, hkv, _ = k_pages.shape
    groups = h // hkv
    scale = (dk ** -0.5) if scale is None else scale
    k = k_pages.float().repeat_interleave(groups, dim=3)        # (B,P,T,H,dk)
    v = v_pages.float().repeat_interleave(groups, dim=3)        # (B,P,T,H,dv)
    s = torch.einsum("bhd,bpthd->bpht", q.float(), k) * scale    # (B,P,H,T)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    tok = torch.arange(t, device=q.device)
    valid = (tok[None, None, :] < page_lengths[:, :, None])[:, :, None, :]
    s = torch.where(valid, s, NEG_INF)
    page_m = s.amax(dim=-1)                                      # (B,P,H)
    page_l = torch.where(valid, torch.exp(s - page_m[..., None]), 0.0).sum(-1)
    m = page_m.amax(dim=1)                                       # (B,H)
    w = torch.where(valid, torch.exp(s - m[:, None, :, None]), 0.0)
    l = w.sum(dim=(1, 3))
    acc = torch.einsum("bpht,bpthd->bhd", w, v)
    return m[..., None], l[..., None], acc, page_m, page_l
