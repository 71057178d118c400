"""NeoMem paged decode: attention over the fast-tier ring of hot KV pages.

Port of the single-device paged path of ``repro/models/decode.py`` for the
dense GQA family.  Cache layout (stacked by pattern group, as the
reference's):

  * paged attn blocks ... {"k_pages","v_pages"}: (G, B, n_slots, T, Hkv, dh)
                          + {"page_len": (G, B, n_slots), "cur_slot": (G, B)}
  * "pos" ............... () int32 lockstep position

The ring IS the NeoMem fast tier; the slow tier (full history) is the KV
resource's store, managed by the serve engine and the daemon between steps.
Where the reference scans over layer groups and prompt tokens, the port
runs Python loops, and it updates the cache IN PLACE (the page tensors are
the bulk of device memory; nothing else holds the old values).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_norm, apply_rope, embed_apply,
                                       logits_apply, mlp_apply)
from repro_torch.models.transformer import check_dense


def _take(tree, g: int):
    """Layer group ``g`` of a group-stacked dict of tensors (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


def init_paged_cache(cfg: ArchConfig, batch: int, n_slots: int, page_t: int,
                     dtype=torch.bfloat16, *, device="cuda"):
    """NeoMem fast-tier paged cache for every attention block."""
    check_dense(cfg)
    g, hkv, dh = cfg.n_groups, cfg.n_kv_heads, cfg.head_dim

    def one():
        return {
            "k_pages": torch.zeros((g, batch, n_slots, page_t, hkv, dh),
                                   dtype=dtype, device=device),
            "v_pages": torch.zeros((g, batch, n_slots, page_t, hkv, dh),
                                   dtype=dtype, device=device),
            "page_len": torch.zeros((g, batch, n_slots), dtype=torch.int32,
                                    device=device),
            "cur_slot": torch.zeros((g, batch), dtype=torch.int32,
                                    device=device),
        }
    return {"blocks": [one() for _ in cfg.pattern],
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _append_attend_local(kp, vp, plen, cur_slot, k_new, v_new, q_eff, *,
                         scale, softcap, page_t, collect_mass):
    """Page append + flash-decode attention over one group's ring, in place.

    ``kp``/``vp`` (B, S, T, Hkv, d), ``plen`` (B, S) and ``cur_slot`` (B,)
    are updated in place: the new K/V goes to the current slot's next
    position, and a slot that fills advances ``cur_slot`` onto the next slot
    with its length zeroed.  Returns (o (B, H, dv) f32, mass (B, S) or None).
    """
    b, n_slots = plen.shape
    bidx = torch.arange(b, device=plen.device)
    cs = cur_slot.long()
    off = plen[bidx, cs]
    kp[bidx, cs, off.long()] = k_new.to(kp.dtype)
    vp[bidx, cs, off.long()] = v_new.to(vp.dtype)
    plen[bidx, cs] = off + 1
    full = off + 1 >= page_t
    new_slot = torch.where(full, (cur_slot + 1) % n_slots, cur_slot)
    advanced = full & (new_slot != cur_slot)
    slots = torch.arange(n_slots, device=plen.device)
    plen.masked_fill_(advanced[:, None] & (slots[None] == new_slot[:, None]), 0)
    cur_slot.copy_(new_slot)
    if collect_mass:
        return pa_ops.paged_attention(q_eff, kp, vp, plen, scale=scale,
                                      softcap=softcap, return_mass=True)
    return pa_ops.paged_attention(q_eff, kp, vp, plen, scale=scale,
                                  softcap=softcap), None


def _paged_attn_block(p, cfg: ArchConfig, x_t, cache, pos, page_t: int,
                      collect_mass: bool = False):
    """One decoder block over the paged ring (GQA branch of the reference's
    ``_paged_attn_block``).  Returns (x_t, mass or None)."""
    h = apply_norm(cfg.norm, p["ln1"], x_t)
    b = x_t.shape[0]
    q, k, v = attn._proj_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim)
    pos_b = pos.reshape(1, 1).expand(b, 1)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k = apply_rope(k, pos_b, cfg.rope_theta)
    scale = (cfg.head_dim ** -0.5) if cfg.attn_scale is None else cfg.attn_scale
    o, mass = _append_attend_local(
        cache["k_pages"], cache["v_pages"], cache["page_len"], cache["cur_slot"],
        k[:, 0], v[:, 0], q[:, 0].float().contiguous(), scale=scale,
        softcap=cfg.attn_softcap, page_t=page_t, collect_mass=collect_mass)
    x_t = x_t + o.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x_t.dtype) \
        @ p["attn"]["wo"]
    y = mlp_apply(p["ffn"], apply_norm(cfg.norm, p["ln2"], x_t), cfg.mlp)
    return x_t + y, mass


def decode_step_paged(cfg: ArchConfig, params, cache, token, *, page_t: int,
                      return_streams: bool = False,
                      collect_mass: bool | None = None):
    """One decode step over the NeoMem fast tier (hot pages only).

    ``token`` (B, 1) int.  Returns ``(logits (B, 1, V) f32, cache)`` and,
    with ``return_streams``, a streams dict whose ``"kv_mass"`` is the
    (G, n_attn, B, n_slots) kernel-exported per-page softmax mass of every
    attention position (``"router"`` is None: the dense family has none).
    ``collect_mass`` (default: follow ``return_streams``) gates the
    kernel's page-stats export.  The cache is updated in place.
    """
    check_dense(cfg)
    collect_mass = return_streams if collect_mass is None else collect_mass
    pos = cache["pos"]
    x = embed_apply(params["embed"], token)
    masses = []
    for g in range(cfg.n_groups):
        group = []
        for i, _kind in enumerate(cfg.pattern):
            x, mass = _paged_attn_block(_take(params["blocks"][i], g), cfg, x,
                                        _take(cache["blocks"][i], g), pos,
                                        page_t, collect_mass)
            if mass is not None:
                group.append(mass)
        masses.append(group)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = logits_apply(params["embed"], x, cfg.final_softcap)
    cache["pos"] = pos + 1
    if not return_streams:
        return logits, cache
    kv_mass = (torch.stack([torch.stack(gm) for gm in masses])
               if collect_mass else None)
    return logits, cache, {"router": None, "kv_mass": kv_mass}


def prefill_paged(cfg: ArchConfig, params, cache, tokens, *, page_t: int,
                  collect_mass: bool = False):
    """Prefill a (B, C) prompt chunk through the paged ring, one token
    column at a time — each step IS :func:`decode_step_paged`, so the ring
    after the chunk equals C streaming calls.

    Returns ``(last logits (B, V) f32, cache, streams)``; streams stacks the
    per-step ``kv_mass`` on a leading chunk axis, (C, G, n_attn, B, S).
    """
    tokens = torch.as_tensor(tokens)
    last, kv_mass = None, []
    for c in range(tokens.shape[1]):
        logits, cache, streams = decode_step_paged(
            cfg, params, cache, tokens[:, c:c + 1], page_t=page_t,
            return_streams=True, collect_mass=collect_mass)
        last = logits[:, -1].float()
        if streams["kv_mass"] is not None:
            kv_mass.append(streams["kv_mass"])
    return last, cache, {"router": None,
                         "kv_mass": torch.stack(kv_mass) if kv_mass else None}
