"""Serving decode: the NeoMem paged decode over the fast-tier ring of hot
KV pages, and the full (dense) cache decode.

Port of the serving paths of ``repro/models/decode.py`` for the dense GQA
family (llama3.2-3b, qwen1.5-4b, stablelm-1.6b, gemma2-27b),
the mixture-of-experts family with GQA (kimi-k2) or MLA (deepseek-v3)
attention, the Mamba2 hybrid with one shared attention block (zamba2) and
the recurrent xLSTM (xlstm), the vision decoder with gated cross attention
(llama-3.2-vision) and the encoder-decoder whisper.  Cache layouts (stacked
by pattern group, as the reference's):

  * dense attn blocks ... {"k","v"}: (G, B, Smax, Hkv, dh)
  * dense MLA blocks .... {"c_kv","k_rope"}: (G, B, Smax, kv_lora | d_rope)
  * mamba blocks ........ {"ssm": (G, B, H, N, P) f32, "conv": (G, B, K-1, C)}
  * m/sLSTM blocks ...... {"c","n","m"} f32 (``m`` starts at -1e30)

  * paged attn blocks ... {"k_pages","v_pages"}: (G, B, n_slots, T, Hkv, dk|dv)
                          + {"page_len": (G, B, n_slots), "cur_slot": (G, B)};
                          GQA: Hkv = n_kv_heads, dk = dv = head_dim; MLA: one
                          latent head, dk = kv_lora + d_rope, dv = kv_lora
  * "prologue" .......... a MoE arch's dense prologue layers: a list of the
                          same ring without the G axis
  * the recurrent blocks keep their O(1) states in both caches (no ring);
    a ``shared_attn`` position has its own cache or ring, read through the
    one weight set ``params["shared_attn"]``
  * "pos" ............... () int32 lockstep position, or (B,) per-lane
                          positions (continuous batching, DESIGN.md §9)

The ring IS the NeoMem fast tier; the slow tier (full history) is the KV
resource's store, managed by the serve engine and the daemon between steps.
Where the reference scans over layer groups and prompt tokens, the port
runs Python loops, and it updates the cache IN PLACE (the page tensors are
the bulk of device memory; nothing else holds the old values).

An MLA block attends in the latent space, as the reference's absorbed
decode: the query's nope part goes through the key half of ``wkv_b`` into
the kv_lora-wide latent, the page rows are ``[c_t | rope(k_r)]`` and ``c_t``,
and the attention output goes back through the value half of ``wkv_b``
before ``wo``.  One latent head serves every query head, so the attention
kernel runs at a group of ``n_heads`` (128 on deepseek-v3).

A MoE block's FFN is the top-k expert layer (:mod:`repro_torch.models.moe`):
with the experts resource bound (``tiered["experts"]``) the first MoE
position of each group reads its experts' weight rows through the
resource's placement table, as the reference's; the router's token->expert
ids come back as the ``"router"`` stream, the experts resource's input.

The dense path (``init_cache``, ``decode_step``, ``prefill_dense``) writes
each step's K/V at ``pos`` in place and attends over every cached position
(``attention.gqa_decode`` / ``mla_decode``, plain torch, as the reference
computes them outside any Pallas kernel); gemma2's sliding ``window``
masks its ``attn_local`` positions there.  The paged path reads no window,
as the reference's does not (ROADMAP C5).  Both apply gemma2's embedding
scale and post-norms.

Cross attention: ``decode_step`` takes ``aux_embeds``, an image's patch
embeddings or, for an encoder arch, the encoder's output (the engine
encodes once at prefill; :func:`repro_torch.models.transformer.encode`).
A ``cross`` block attends over it after its self-attention residual and
adds the result scaled by ``tanh(xgate)``, a ``dec`` block adds it ungated
(:func:`_cross_step`); without ``aux_embeds`` both run as self-attention
blocks.  Their caches are GQA's.  No cross K/V is cached: every step
projects the whole of ``aux_embeds`` again in every cross layer, as the
reference's; over a mesh that projection is split over 'model', each rank
projecting its column blocks of k and v of every ``aux_embeds`` position.  The paged path has no cross step at all: the reference's
``_paged_attn_block`` takes no ``aux``, so on the ring both kinds are
self-attention blocks (ROADMAP C6).

Lane masks: where the reference computes a new cache for every lane and
``merge_cache`` keeps the old leaves of the inactive ones, the port's
writes are conditional on the mask — an inactive lane's pages, ``page_len``,
``cur_slot``, recurrent states and ``pos`` stay bitwise unchanged and the
ring is never copied.  Its logits, mass and router ids are computed on the
unchanged ring and are not to be read.  ``merge_cache`` therefore has no
counterpart: the paged writes are masked in place, and the dense cache has
no lanes.

Over a mesh (the reference's ``smesh`` and ``ep_axes``): the paged decode
and prefill take ``smesh`` ({"mesh", "axes"}), which splits the ring's page
slots over those axes, each rank holding its slots, appending where it owns
the current slot and merging the ranks' attention statistics
(:func:`_append_attend_sharded`; the query it attends with is gathered
whole over 'model' first); every decode and prefill takes
``ep_axes``, an :class:`repro_torch.models.moe.EPContext` that runs the MoE
layers expert-parallel, and ``layout``, which gathers the rank's stored
param blocks a group at a time and, for every arch, partitions the
embedding, each block's q/k/v (MLA's projections), ``wo`` and MLP (a MoE
block's shared expert; the dense prologue's blocks and zamba2's shared
block too), each recurrent mixer by heads or channels (its state read at
the rank's share and the new state gathered whole, as the cache rests),
each cross step (``xattn``: by heads, by head columns, or whole on the
gathered columns where neither divides, :func:`attention.core_form` at one
query) and the head over 'model' (:mod:`repro_torch.models.attention`'s
decode form: the self-attention core at one query position takes q, k and
v gathered whole, MLA's the absorbed query gathered over the heads).  The
dense decode and prefill also take ``cache_layout``: where a block's cache
has its sequence split over 'model' (``cache_pspecs``; the body blocks,
the dense prologue, zamba2's shared block, the self cores of the
``cross`` and ``dec`` blocks), its core attends over the rank's block of
the sequence and the ranks merge their softmax statistics
(:mod:`repro_torch.models.attention`'s split cache); nothing of the cache
is gathered.  The ring's core runs replicated, as the reference's does
unless ``smesh`` splits its slots.  The
logits are gathered whole over 'model' before they are returned, so that
greedy ids and :func:`sample_tokens` read the whole vocab.

Also here, as in the reference: ``install_pages``, which fast-forwards one
lane over complete KV pages from the reuse pool (in place, that lane
only), and the lane sampler (``fold_lane_keys``, ``sample_tokens``) over
the threefry port in :mod:`repro_torch.models.prng`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import per_group
from repro_torch.kernels.paged_attn import ops as pa_ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import prng
from repro_torch.models.layers import (apply_norm, apply_rope, embed_apply,
                                       gather_logits, logits_apply, mlp_apply)
from repro_torch.models.mamba2 import mamba2_decode, mamba2_init_cache
from repro_torch.models.transformer import (RECURRENT_KINDS, _body_parts,
                                            _head_part, _top, check_ported,
                                            forward)
from repro_torch.models.xlstm import (mlstm_decode, mlstm_init_cache,
                                      slstm_decode, slstm_init_cache)
from repro_torch.tiering.migrate import lookup_rows as _tier_lookup_rows


def _take(tree, g: int):
    """Layer group ``g`` of a group-stacked dict of tensors (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


# attention-cache leaves the dense decode's cores attended over a mesh
# (``decode_step``'s ``cache_layout``), by form: "split", the rank's block
# of the sequence; "whole", a cache whose sequence is not split
CACHE_LEAVES = {"split": 0, "whole": 0}


class _MeshBlocks:
    """Over a mesh, a group's params as a block computes with them,
    gathered under ``layout`` (:class:`repro_torch.dist.sharding.Layout`),
    and how its cache rests under ``cache_layout`` (specs without their
    data axes: the batch stays split, compute is data-parallel): a block
    whose cache has its sequence dim split over 'model' attends over the
    rank's block of it (:meth:`seq`)."""

    def __init__(self, layout, cache_layout):
        self.layout, self.cache_layout = layout, cache_layout
        self.gp = None if layout is None else per_group(layout.specs["blocks"])
        self.gc = (None if cache_layout is None
                   else per_group(cache_layout.specs["blocks"]))

    def params(self, p, i: int):
        return p if self.layout is None else self.layout.gather(p, self.gp[i])

    def parts(self, block: str) -> dict:
        """The {"attn", "ffn", "mix", "xattn"} parts of 'model' of the block
        at ``block`` ("blocks/0", "prologue/1")."""
        return {} if self.layout is None else self.layout.parts(block)

    def seq(self, specs):
        """The Part of 'model' whose rank's block of the sequence an
        attention block's cache leaves hold under ``specs`` ({leaf: spec},
        (B, S, ...) each), or None where none is split (counted in
        CACHE_LEAVES)."""
        if specs is None:
            return None
        split = [tuple(sp) != (None,) * len(sp) for sp in specs.values()]
        if any(split) and not all(tuple(sp) == (None, "model") + (None,) * (len(sp) - 2)
                                  for sp in specs.values()):
            raise ValueError(f"decode: a dense cache split other than its sequence "
                             f"over 'model': {specs}")
        CACHE_LEAVES["split" if any(split) else "whole"] += len(specs)
        if not any(split):
            return None
        mesh = self.cache_layout.mesh
        return col.Part(mesh.group("model"), mesh.coord("model"),
                        mesh.axis_size("model"))


def _embed_tokens(params, token, tiered, part=None):
    """Token embedding, served from the NeoMem tiered store when bound.

    With a ``tiered["embeddings"]`` view ({"fast", "slow", "page_slot",
    "rows_per_page"}) each token's vocab row-block is gathered through the
    placement table (:func:`repro_torch.tiering.migrate.lookup_rows`): the
    fast-buffer copy when promoted, the slow store otherwise — bitwise the
    table's row either way (the tiers are inclusive).  On the card the slow
    store is pinned host memory, so the gather goes through a staging copy.
    Without it, ``part`` looks up the rank's vocab rows of the table
    (:func:`repro_torch.models.layers.embed_apply`)."""
    tv = (tiered or {}).get("embeddings")
    if tv is None:
        return embed_apply(params["embed"], token, part)
    rpp = tv["rows_per_page"]
    rows = _tier_lookup_rows(tv["fast"], tv["slow"], tv["page_slot"],
                             torch.div(token, rpp, rounding_mode="floor"),
                             scale=tv.get("scale"))          # (B, 1, rpp, d)
    r = torch.remainder(token, rpp)[..., None, None]
    return torch.take_along_dim(rows, r, dim=-2)[..., 0, :]


def _embed(cfg: ArchConfig, params, token, tiered, part=None):
    """The step's token embedding, scaled by sqrt(d) where the arch asks
    (gemma), in float32 and rounded back as the reference's."""
    x = _embed_tokens(params, token, tiered, part)
    if cfg.embed_scale:
        x = (x.float() * cfg.d_model ** 0.5).to(x.dtype)
    return x


def ring_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(kv heads, K width, V width) of a ring page row: MLA keeps one latent
    head of ``[c | k_rope]`` keys and ``c`` values, GQA its kv heads."""
    if cfg.mla is not None:
        return 1, cfg.mla.kv_lora + cfg.mla.d_rope, cfg.mla.kv_lora
    return cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


def init_paged_cache(cfg: ArchConfig, batch: int, n_slots: int, page_t: int,
                     dtype=torch.bfloat16, per_lane_pos: bool = False, *,
                     device="cuda"):
    """NeoMem fast-tier paged cache for every attention block, the dense
    prologue's rings included; the recurrent blocks' O(1) states.

    ``per_lane_pos=True`` makes ``pos`` a (batch,) vector so each batch row
    (a continuous-batching lane) advances on its own (DESIGN.md §9)."""
    check_ported(cfg)
    hkv, dk, dv = ring_dims(cfg)

    def one(lead, kind="attn"):
        if kind in RECURRENT_KINDS:
            return recurrent_cache(cfg, kind, batch, lead, dtype, device)
        return {
            "k_pages": torch.zeros(lead + (batch, n_slots, page_t, hkv, dk),
                                   dtype=dtype, device=device),
            "v_pages": torch.zeros(lead + (batch, n_slots, page_t, hkv, dv),
                                   dtype=dtype, device=device),
            "page_len": torch.zeros(lead + (batch, n_slots), dtype=torch.int32,
                                    device=device),
            "cur_slot": torch.zeros(lead + (batch,), dtype=torch.int32,
                                    device=device),
        }
    out = {"blocks": [one((cfg.n_groups,), kind) for kind in cfg.pattern],
           "pos": torch.zeros((batch,) if per_lane_pos else (),
                              dtype=torch.int32, device=device)}
    if cfg.moe and cfg.moe.n_dense_prologue:
        out["prologue"] = [one(()) for _ in range(cfg.moe.n_dense_prologue)]
    return out


def recurrent_cache(cfg: ArchConfig, kind: str, batch: int, lead=(),
                    dtype=torch.bfloat16, device="cuda") -> dict:
    """A recurrent block's initial decode state (``lead`` stacks it): the
    same in the full cache and the paged one."""
    if kind == "mamba":
        s = cfg.ssm
        return mamba2_init_cache(batch, cfg.d_model, expand=s.expand,
                                 headdim=s.headdim, n_groups=s.n_groups,
                                 d_state=s.d_state, d_conv=s.d_conv, lead=lead,
                                 dtype=dtype, device=device)
    if kind == "mlstm":
        return mlstm_init_cache(batch, cfg.d_model, cfg.mlstm_heads, lead=lead,
                                device=device)
    return slstm_init_cache(batch, cfg.d_model, lead=lead, device=device)


def _recurrent_block(p, cfg: ArchConfig, kind: str, x_t, cache, active=None,
                     part=None):
    """One recurrent block (the reference's mamba, mlstm and slstm branches
    of ``_decode_block``): norm, mixer, residual.  The new state is written
    into ``cache`` in place, for the ``active`` (B,) lanes only when given
    (an inactive lane's state stays bitwise unchanged).  ``part`` partitions
    the mixer over 'model' (its new state comes back whole, as the cache
    rests)."""
    h = apply_norm(cfg.norm, p["ln"], x_t)
    if kind == "mamba":
        s = cfg.ssm
        o, new = mamba2_decode(p["mix"], h, cache, headdim=s.headdim,
                               n_groups=s.n_groups, d_state=s.d_state, part=part)
    elif kind == "mlstm":
        o, new = mlstm_decode(p["mix"], h, cache, n_heads=cfg.mlstm_heads, part=part)
    else:
        o, new = slstm_decode(p["mix"], h, cache, part=part)
    for k, v in new.items():
        dst = cache[k]
        if active is not None:
            v = torch.where(active.view((-1,) + (1,) * (dst.dim() - 1)), v, dst)
        dst.copy_(v)
    return x_t + o


def _append_attend_local(kp, vp, plen, cur_slot, k_new, v_new, q_eff, *,
                         scale, softcap, page_t, collect_mass, active=None):
    """Page append + flash-decode attention over one group's ring, in place.

    ``kp``/``vp`` (B, S, T, Hkv, d), ``plen`` (B, S) and ``cur_slot`` (B,)
    are updated in place: the new K/V goes to the current slot's next
    position, and a slot that fills advances ``cur_slot`` onto the next slot
    with its length zeroed.  ``active`` (B,) bool limits every write to the
    active rows (an inactive row writes its slot's old contents back).
    Returns (o (B, H, dv) f32, mass (B, S) or None).
    """
    b, n_slots = plen.shape
    bidx = torch.arange(b, device=plen.device)
    cs = cur_slot.long()
    off = plen[bidx, cs]
    at = off.long()
    k_new, v_new = k_new.to(kp.dtype), v_new.to(vp.dtype)
    grow = 1
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, kp[bidx, cs, at])
        v_new = torch.where(keep, v_new, vp[bidx, cs, at])
        grow = active.to(plen.dtype)
    kp[bidx, cs, at] = k_new
    vp[bidx, cs, at] = v_new
    plen[bidx, cs] = off + grow
    full = off + 1 >= page_t
    if active is not None:
        full = full & active
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


def _append_attend_sharded(kp, vp, plen, cur_slot, k_new, v_new, q_eff, *,
                           scale, softcap, page_t, collect_mass, smesh,
                           active=None):
    """:func:`_append_attend_local` with the ring's page slots split over
    ``smesh["axes"]`` of ``smesh["mesh"]``: ``kp``/``vp``/``plen`` are the
    rank's (B, S_local, ...) slots (slots ``rank * S_local`` onwards, the
    rank linear over the axes), ``cur_slot`` the global slot, the same on
    every rank.  The rank owning the current slot appends; whether it
    filled is summed over the ranks, and the next slot's length is zeroed
    wherever it lives.  Each rank runs the attention kernel over its slots
    and :func:`repro_torch.kernels.paged_attn.ops.combine_stats` merges
    them (the page mass comes back for the local slots).  Returns (o (B,
    H, dv) f32, the local mass (B, S_local) or None)."""
    mesh, axes = smesh["mesh"], tuple(smesh["axes"])
    group = mesh.group(axes)
    b, n_local = plen.shape
    lo = mesh.coord(axes) * n_local
    bidx = torch.arange(b, device=plen.device)
    lslot = cur_slot.long() - lo
    own = (lslot >= 0) & (lslot < n_local)
    if active is not None:
        own = own & active
    safe = lslot.clamp(0, n_local - 1)
    off = plen[bidx, safe]
    at = off.long().clamp_max(kp.shape[2] - 1)      # a rank that does not own
    keep = own[:, None, None]                        # the slot writes back
    kp[bidx, safe, at] = torch.where(keep, k_new.to(kp.dtype), kp[bidx, safe, at])
    vp[bidx, safe, at] = torch.where(keep, v_new.to(vp.dtype), vp[bidx, safe, at])
    plen[bidx, safe] = off + own.to(plen.dtype)
    full_here = own & (off + 1 >= page_t)
    full = col.all_reduce(full_here.to(torch.int32), group) > 0
    n_total = n_local * mesh.axis_size(axes)
    new_slot = torch.where(full, (cur_slot + 1) % n_total, cur_slot)
    nls = new_slot.long() - lo
    nown = (nls >= 0) & (nls < n_local) & full & (new_slot != cur_slot)
    slots = torch.arange(n_local, device=plen.device)
    plen.masked_fill_(nown[:, None] & (slots[None] == nls[:, None]), 0)
    cur_slot.copy_(new_slot)
    stats = pa_ops.paged_attention_local_stats(q_eff, kp, vp, plen, scale=scale,
                                               softcap=softcap,
                                               return_page_stats=collect_mass)
    if collect_mass:
        m, l, acc, page_m, page_l = stats
        return pa_ops.combine_stats(m, l, acc, group, page_m=page_m, page_l=page_l)
    return pa_ops.combine_stats(*stats, group), None


def _moe_block(p, cfg: ArchConfig, h2, tiered_moe, router: list, ep_axes=None,
               part=None):
    """The MoE FFN of a block: through the experts resource's placement
    table when the engine bound its view for this position, else over the
    dense expert weights (expert-parallel under ``ep_axes``); ``part``
    partitions the shared expert.  The router's (B, 1, k) ids go to
    ``router``."""
    if tiered_moe is not None:
        y, idx, _ = moe_lib.moe_apply_tiered(
            p["ffn"], h2, cfg.moe.top_k, bias=p.get("router_bias"),
            tier=tiered_moe["view"], group_id=tiered_moe["group_id"], part=part)
    else:
        y, idx, _ = moe_lib.moe_apply_ep(p["ffn"], h2, cfg.moe.top_k,
                                         bias=p.get("router_bias"), ep_axes=ep_axes,
                                         part=part)
    router.append(idx)
    return y


def _tiered_moe_for(cfg: ArchConfig, tiered, i: int, g: int):
    """Expert tier view for pattern position ``i`` of group ``g``, or None.
    Only the FIRST MoE position reads through the tiered store: its weights
    are the payload rows the serve engine bound (DESIGN.md §8)."""
    if not tiered or "experts" not in tiered:
        return None
    if "moe" not in cfg.pattern or i != cfg.pattern.index("moe"):
        return None
    return {"view": tiered["experts"], "group_id": g}


def _mla_qkv(pa, cfg: ArchConfig, h, pos_b, part=None):
    """MLA's absorbed decode inputs (the reference's MLA branch): the latent
    query ``[q_nope @ w_k, rope(q_rope)]`` (B, H, kv_lora + d_rope) f32, the
    new page rows ``[c_t | rope(k_r)]`` and ``c_t`` (B, 1, dk|dv), and the
    softmax scale ``(d_nope + d_rope) ** -0.5``.  With ``part`` the rank
    projects its heads' latent queries (its blocks of ``wq_b`` and
    ``wkv_b``) and the absorbed query is gathered over the heads, so that
    the core attends replicated."""
    m, b = cfg.mla, h.shape[0]
    hl = attn._mla_heads(cfg.n_heads, part)
    if not hl:
        raise ValueError(f"{cfg.n_heads} MLA heads do not divide {part.size} ranks")
    qa, kv_a = attn._mla_latent(pa, h, part)
    q = (qa @ pa["wq_b"]).reshape(b, hl, m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope[:, None], pos_b, cfg.rope_theta)[:, 0]
    w_k = pa["wkv_b"].reshape(m.kv_lora, hl, m.d_nope + m.d_v)[..., :m.d_nope]
    q_lat = torch.einsum("bhd,khd->bhk", q_nope.float(), w_k.float())
    q_eff = torch.cat([q_lat, q_rope.float()], dim=-1)
    if part is not None:
        q_eff = col.gather(q_eff, 1, part.group, reduce=True)
    kv_a = kv_a[:, 0]
    c_t = attn._rms(kv_a[..., :m.kv_lora], attn._kv_norm(pa, part))
    kr_t = apply_rope(kv_a[:, None, None, m.kv_lora:], pos_b,
                      cfg.rope_theta)[:, 0, 0]
    k_new = torch.cat([c_t, kr_t], dim=-1)[:, None, :]
    return q_eff, k_new, c_t[:, None, :], (m.d_nope + m.d_rope) ** -0.5


def _mla_out(pa, cfg: ArchConfig, o, dtype, part=None):
    """The latent attention output (B, H, kv_lora) f32 through the value
    half of ``wkv_b`` in float32, then ``wo``: (B, 1, d); with ``part`` the
    rank's heads of it through its blocks, the parts summed."""
    m, b = cfg.mla, o.shape[0]
    hl = attn._mla_heads(cfg.n_heads, part)
    if part is not None:
        o = part.block(o, 1)
    w_v = pa["wkv_b"].reshape(m.kv_lora, hl, m.d_nope + m.d_v)[..., m.d_nope:]
    o = torch.einsum("bhk,khd->bhd", o, w_v.float())
    o = o.reshape(b, 1, hl * m.d_v).to(dtype) @ pa["wo"]
    return o if part is None else col.sum_parts(o, part.group)


def _paged_attn_block(p, cfg: ArchConfig, kind: str, x_t, cache, pos,
                      page_t: int, collect_mass: bool = False, active=None,
                      tiered_moe=None, router: list | None = None, smesh=None,
                      ep_axes=None, parts=None):
    """One decoder block over the paged ring (the GQA and MLA branches of
    the reference's ``_paged_attn_block``), its slots split over ``smesh``
    when given; ``kind`` "moe" runs the expert layer as its FFN; ``parts``
    ({"attn", "ffn"}) partitions the projections and the MLP over 'model'.
    Returns (x_t, mass or None)."""
    parts = parts or {}
    h = apply_norm(cfg.norm, p["ln1"], x_t)
    b = x_t.shape[0]
    pos_b = attn._pos_col(pos, b)
    if cfg.mla is not None:
        q_eff, k_new, v_new, scale = _mla_qkv(p["attn"], cfg, h, pos_b,
                                              parts.get("attn"))
    else:
        q, k, v = attn._proj_qkv(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, parts.get("attn"))
        if cfg.rope_theta > 0:
            q = apply_rope(q, pos_b, cfg.rope_theta)
            k = apply_rope(k, pos_b, cfg.rope_theta)
        q_eff, k_new, v_new = q[:, 0].float().contiguous(), k[:, 0], v[:, 0]
        scale = (cfg.head_dim ** -0.5) if cfg.attn_scale is None else cfg.attn_scale
    kw = dict(scale=scale, softcap=cfg.attn_softcap, page_t=page_t,
              collect_mass=collect_mass, active=active)
    if smesh is not None:
        kw["smesh"] = smesh
    o, mass = (_append_attend_local if smesh is None else _append_attend_sharded)(
        cache["k_pages"], cache["v_pages"], cache["page_len"], cache["cur_slot"],
        k_new, v_new, q_eff, **kw)
    if cfg.mla is not None:
        o = _mla_out(p["attn"], cfg, o, x_t.dtype, parts.get("attn"))
    else:
        o = attn.out_proj(p["attn"], o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
                          .to(x_t.dtype), parts.get("attn"))
    return _block_tail(p, cfg, kind, x_t, o, tiered_moe, router,
                       ep_axes=ep_axes, ffn_part=parts.get("ffn")), mass


def _block_tail(p, cfg: ArchConfig, kind: str, x_t, o, tiered_moe, router,
                kv_src=None, ep_axes=None, ffn_part=None, xattn_part=None):
    """Everything of a decoder block after its attention output ``o``: the
    residual, the cross step over ``kv_src`` where the dense path gives one
    (with ``xattn_part`` over the rank's blocks), the FFN (the expert layer
    for ``kind`` "moe"; with ``ffn_part`` the MLP, or the expert layer's
    shared expert, over the rank's blocks) and, where the arch has them
    (gemma2), the post-norms of both branches."""
    if cfg.post_norm:
        o = apply_norm(cfg.norm, p["pn1"], o)
    x_t = x_t + o
    if kv_src is not None:
        x_t = _cross_step(p, cfg, kind, x_t, kv_src, xattn_part)
    h2 = apply_norm(cfg.norm, p["ln2"], x_t)
    if kind == "moe":
        y = _moe_block(p, cfg, h2, tiered_moe, router, ep_axes, ffn_part)
    else:
        y = mlp_apply(p["ffn"], h2, cfg.mlp, part=ffn_part)
    if cfg.post_norm:
        y = apply_norm(cfg.norm, p["pn2"], y)
    return x_t + y


def _cross_step(p, cfg: ArchConfig, kind: str, x_t, kv_src, part=None):
    """A ``cross`` or ``dec`` block's cross attention over ``kv_src`` and its
    residual: a ``cross`` block's output is scaled by ``tanh(xgate)`` in
    float32 and rounded back, a ``dec`` block's added as it is.  With
    ``part`` the rank projects its columns of q and of every ``kv_src``
    position's k and v, and the core runs by heads, by head columns or
    whole on the gathered columns (:func:`attention.cross_apply`)."""
    hx = apply_norm(cfg.norm, p["lnx"], x_t)
    xo = attn.cross_apply(p["xattn"], hx, kv_src, h=cfg.n_heads,
                          hkv=cfg.n_kv_heads, dh=cfg.head_dim, part=part)
    if kind == "cross":
        return x_t + (torch.tanh(p["xgate"]) * xo.float()).to(x_t.dtype)
    return x_t + xo


def _cross_source(cfg: ArchConfig, kind: str, aux_embeds):
    """What a block's cross step attends over: ``aux_embeds`` for a
    ``cross`` block of an arch without an encoder and for a ``dec`` block
    of one with an encoder (the reference renames it ``enc_out`` there),
    else None (no cross step)."""
    if (kind == "cross" and not cfg.encoder_layers) or \
            (kind == "dec" and cfg.encoder_layers):
        return aux_embeds
    return None


def decode_step_paged(cfg: ArchConfig, params, cache, token, *, page_t: int,
                      return_streams: bool = False,
                      collect_mass: bool | None = None, tiered=None,
                      active=None, ep_axes=None, smesh=None, layout=None):
    """One decode step over the NeoMem fast tier (hot pages only).

    ``token`` (B, 1) int.  Returns ``(logits (B, 1, V) f32, cache)`` and,
    with ``return_streams``, a streams dict: ``"kv_mass"`` is the
    (G, n_attn, B, n_slots) kernel-exported per-page softmax mass of every
    body attention position (the dense prologue exports none, as in the
    reference; None for a pattern without attention), ``"router"`` the
    (G, n_moe, B, 1, k) int32 token->expert ids of every MoE position (None
    without one).
    ``collect_mass`` (default: follow ``return_streams``) gates the
    kernel's page-stats export.  ``tiered`` serves the token embedding
    (:func:`_embed_tokens`) and the first MoE position's expert weights
    (:func:`_tiered_moe_for`) through the tiered store.  ``active`` (B,)
    bool masks whole lanes: an inactive lane's cache leaves stay bitwise
    unchanged (needs per-lane positions).  The cache is updated in place.

    Over a mesh: ``smesh`` ({"mesh", "axes"}) splits the ring's page slots
    over those axes (the cache holds the rank's slots, as
    :func:`repro_torch.dist.sharding.cache_pspecs` with ``slot_axes``
    places them; :func:`_append_attend_sharded`), and the kv mass comes
    back for the local slots; ``ep_axes`` runs the MoE layers
    expert-parallel (``params``' expert stacks the rank's blocks);
    ``layout`` gathers the rank's stored param blocks a group at a time, as
    :func:`decode_step`'s, and partitions the arch over 'model'.
    """
    check_ported(cfg)
    mb = _MeshBlocks(layout, None)
    params = _top(params, layout)
    head = _head_part(layout)
    collect_mass = return_streams if collect_mass is None else collect_mass
    pos = cache["pos"]
    if active is not None and pos.dim() == 0:
        raise ValueError("a lane mask needs per-lane positions "
                         "(init_paged_cache(per_lane_pos=True))")
    x = _embed(cfg, params, token, tiered, head)
    for j, (lp, lc) in enumerate(zip(params.get("prologue", []),
                                     cache.get("prologue", []))):
        x, _ = _paged_attn_block(lp, cfg, "attn", x, lc, pos, page_t,
                                 active=active, smesh=smesh,
                                 parts=mb.parts(f"prologue/{j}"))
    masses, routers = [], []
    for g in range(cfg.n_groups):
        group, router = [], []
        for i, kind in enumerate(cfg.pattern):
            p = mb.params(_take(params["blocks"][i], g), i)
            c = _take(cache["blocks"][i], g)
            parts = _body_parts(cfg, layout, i)
            if kind in RECURRENT_KINDS:
                x = _recurrent_block(p, cfg, kind, x, c, active, parts.get("mix"))
                continue
            if kind == "shared_attn":
                p, kind = params["shared_attn"], "attn"
            x, mass = _paged_attn_block(
                p, cfg, kind, x, c, pos, page_t, collect_mass, active,
                tiered_moe=_tiered_moe_for(cfg, tiered, i, g), router=router,
                smesh=smesh, ep_axes=ep_axes, parts=parts)
            if mass is not None:
                group.append(mass)
        masses.append(group)
        routers.append(router)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = gather_logits(logits_apply(params["embed"], x, cfg.final_softcap, head),
                           head)
    cache["pos"] = pos + (1 if active is None else active.to(pos.dtype))
    if not return_streams:
        return logits, cache
    kv_mass = (torch.stack([torch.stack(gm) for gm in masses])
               if masses[0] else None)
    router = (torch.stack([torch.stack(gr) for gr in routers])
              if routers[0] else None)
    return logits, cache, {"router": router, "kv_mass": kv_mass}


def _stack_steps(steps: list, fill):
    """Stack per-column streams on a leading chunk axis; a skipped column
    (None) becomes a block of ``fill`` shaped like the others, or the whole
    stream None when no column produced it."""
    ran = [m for m in steps if m is not None]
    if not ran:
        return None
    return torch.stack([torch.full_like(ran[0], fill) if m is None else m
                        for m in steps])


def prefill_paged(cfg: ArchConfig, params, cache, tokens, *, page_t: int,
                  valid=None, active=None, tiered=None,
                  collect_mass: bool = False, ep_axes=None, smesh=None,
                  layout=None):
    """Prefill a (B, C) prompt chunk through the paged ring, one token
    column at a time — each step IS :func:`decode_step_paged`, so the ring
    after the chunk equals C streaming calls.

    ``valid`` (B, C) bool marks real tokens (False = ragged-tail padding, a
    no-op step for that lane) and ``active`` (B,) bool masks whole lanes;
    both are host arrays.  A column that is padding for every lane is
    skipped.  Returns ``(last valid logits (B, V) f32, cache, streams)``;
    streams stacks the per-step ``kv_mass`` and ``router`` on a leading
    chunk axis, (C, G, n_attn, B, S) and (C, G, n_moe, B, 1, k): a skipped
    column's mass is zeros and its router ids -1 (padding to every reader).
    ``ep_axes``, ``smesh`` and ``layout`` as in :func:`decode_step_paged`.
    """
    tokens = torch.as_tensor(tokens)
    b, c = tokens.shape
    step_act = None
    if valid is not None or active is not None:
        step_act = (np.ones((b, c), bool) if valid is None
                    else np.asarray(valid, bool))
        if active is not None:
            step_act = step_act & np.asarray(active, bool)[:, None]
    last = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                       device=tokens.device)
    kv_mass, router = [], []
    for j in range(c):
        act = None
        if step_act is not None:
            if not step_act[:, j].any():
                kv_mass.append(None)
                router.append(None)
                continue
            act = torch.as_tensor(step_act[:, j], device=tokens.device)
        logits, cache, streams = decode_step_paged(
            cfg, params, cache, tokens[:, j:j + 1], page_t=page_t,
            return_streams=True, collect_mass=collect_mass, tiered=tiered,
            active=act, ep_axes=ep_axes, smesh=smesh, layout=layout)
        step = logits[:, -1].float()
        last = step if act is None else torch.where(act[:, None], step, last)
        kv_mass.append(streams["kv_mass"])
        router.append(streams["router"])
    return last, cache, {"router": _stack_steps(router, -1),
                         "kv_mass": _stack_steps(kv_mass, 0.0)}


# ---------------------------------------------------------------------------
# full (dense) cache decode
# ---------------------------------------------------------------------------

def _block_cache(cfg: ArchConfig, kind: str, batch: int, smax: int, dtype,
                 device):
    """One block's full cache: a recurrent block's O(1) state, else MLA's
    latent and rope key, else GQA's K and V."""
    if kind in RECURRENT_KINDS:
        return recurrent_cache(cfg, kind, batch, dtype=dtype, device=device)
    if cfg.mla is not None:
        return attn.mla_init_cache(batch, smax, cfg.mla.kv_lora, cfg.mla.d_rope,
                                   dtype, device)
    return attn.gqa_init_cache(batch, smax, cfg.n_kv_heads, cfg.head_dim, dtype,
                               device)


def _stacked(tree, g: int):
    """A block cache with a leading group axis of ``g``, every group the
    initial values (the reference broadcasts one group's)."""
    return {k: v.expand((g,) + v.shape).clone() for k, v in tree.items()}


def init_cache(cfg: ArchConfig, batch: int, smax: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """Full (dense) KV cache of ``smax`` positions for every attention
    block and the recurrent blocks' O(1) states, group-stacked, the dense
    prologue's unstacked; ``pos`` is a () int32 tensor."""
    check_ported(cfg)
    out = {"blocks": [_stacked(_block_cache(cfg, kind, batch, smax, dtype, device),
                               cfg.n_groups) for kind in cfg.pattern],
           "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.moe and cfg.moe.n_dense_prologue:
        out["prologue"] = [_block_cache(cfg, "attn", batch, smax, dtype, device)
                           for _ in range(cfg.moe.n_dense_prologue)]
    return out


def _decode_attn_block(p, cfg: ArchConfig, kind: str, x_t, cache, pos,
                       tiered_moe=None, router: list | None = None,
                       kv_src=None, ep_axes=None, parts=None, seq=None):
    """One decoder block over the full cache (the reference's
    ``_decode_attn_block``): GQA with the sliding window on ``attn_local``
    positions, or MLA's absorbed decode, then the cross step over
    ``kv_src`` when given; ``parts`` as in :func:`_paged_attn_block`;
    ``seq``: the cache is the rank's block of the sequence, split over
    that Part of 'model' (:func:`repro_torch.models.attention.gqa_decode`)."""
    parts = parts or {}
    h = apply_norm(cfg.norm, p["ln1"], x_t)
    if cfg.mla is not None:
        o = attn.mla_decode(p["attn"], h, cache, pos, h=cfg.n_heads,
                            rope_theta=cfg.rope_theta,
                            q_lora=cfg.mla.q_lora, kv_lora=cfg.mla.kv_lora,
                            d_nope=cfg.mla.d_nope, d_rope=cfg.mla.d_rope,
                            d_v=cfg.mla.d_v, part=parts.get("attn"), seq=seq)
    else:
        o = attn.gqa_decode(p["attn"], h, cache, pos, h=cfg.n_heads,
                            hkv=cfg.n_kv_heads, dh=cfg.head_dim,
                            rope_theta=cfg.rope_theta,
                            window=cfg.window if kind == "attn_local" else 0,
                            softcap=cfg.attn_softcap, scale=cfg.attn_scale,
                            part=parts.get("attn"), seq=seq)
    return _block_tail(p, cfg, kind, x_t, o, tiered_moe, router, kv_src, ep_axes,
                       parts.get("ffn"), parts.get("xattn"))


def decode_step(cfg: ArchConfig, params, cache, token, *, aux_embeds=None,
                return_streams: bool = False, tiered=None, ep_axes=None,
                layout=None, cache_layout=None):
    """One decode step over the full cache: ``token`` (B, 1) int ->
    ``(logits (B, 1, V) f32, cache)``, and with ``return_streams`` a
    streams dict whose ``"router"`` is the (G, n_moe, B, 1, k) token->expert
    stream (None for a dense FFN).  ``aux_embeds`` (B, S_aux, D) is what the
    cross blocks attend over: an image's patch embeddings, or for an
    encoder arch the encoder's output, encoded once beforehand.  ``tiered``
    serves the token embedding and the first MoE position's expert weights
    through the tiered store, as in :func:`decode_step_paged`, and
    ``ep_axes`` runs the MoE layers expert-parallel.  The cache is updated
    in place.

    Over a mesh ``params`` and ``cache`` are the rank's blocks:
    ``layout`` gathers a group's params before it runs (as
    :func:`repro_torch.models.transformer.forward`'s) and ``cache_layout``
    (specs without their data axes) says how each block's cache rests.
    Where its sequence is split over 'model' (``cache_pspecs`` wherever the
    length divides the ranks) the block's core attends over the rank's
    block of it and the ranks merge their softmax statistics, as XLA's
    partitioner runs the reference's program; a recurrent state is the
    rank's rows.  Every arch computes its share over 'model', the cross
    step's too (:func:`decode_step_paged`)."""
    check_ported(cfg)
    mb = _MeshBlocks(layout, cache_layout)
    params = _top(params, layout)
    head = _head_part(layout)
    pos = cache["pos"]
    x = _embed(cfg, params, token, tiered, head)
    for j, (lp, lc) in enumerate(zip(params.get("prologue", []),
                                     cache.get("prologue", []))):
        seq = mb.seq(None if cache_layout is None else cache_layout.specs["prologue"][j])
        x = _decode_attn_block(lp, cfg, "attn", x, lc, pos, ep_axes=ep_axes,
                               parts=mb.parts(f"prologue/{j}"), seq=seq)
    routers = []
    for g in range(cfg.n_groups):
        router = []
        for i, kind in enumerate(cfg.pattern):
            p = mb.params(_take(params["blocks"][i], g), i)
            c = _take(cache["blocks"][i], g)
            parts = _body_parts(cfg, layout, i)
            if kind in RECURRENT_KINDS:
                x = _recurrent_block(p, cfg, kind, x, c, part=parts.get("mix"))
            else:
                if kind == "shared_attn":
                    p, kind = params["shared_attn"], "attn"
                x = _decode_attn_block(
                    p, cfg, kind, x, c, pos,
                    tiered_moe=_tiered_moe_for(cfg, tiered, i, g), router=router,
                    kv_src=_cross_source(cfg, kind, aux_embeds), ep_axes=ep_axes,
                    parts=parts, seq=mb.seq(None if mb.gc is None else mb.gc[i]))
        routers.append(router)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    logits = gather_logits(logits_apply(params["embed"], x, cfg.final_softcap, head),
                           head)
    cache["pos"] = pos + 1
    if not return_streams:
        return logits, cache
    router = (torch.stack([torch.stack(gr) for gr in routers])
              if routers[0] else None)
    return logits, cache, {"router": router}


def prefill(cfg: ArchConfig, params, tokens, *, aux_embeds=None, remat=True,
            ep_axes=None, layout=None):
    """The last token's logits of a full-sequence forward, and the
    forward's aux (the reference's dry-run prefill: it builds no cache;
    serving fills one with :func:`prefill_dense` or
    :func:`prefill_paged`).  ``ep_axes`` and ``layout`` as
    :func:`repro_torch.models.transformer.forward`'s."""
    x, aux = forward(cfg, params, tokens, aux_embeds=aux_embeds, remat=remat,
                     ep_axes=ep_axes, layout=layout)
    embed, head = _top(params, layout)["embed"], _head_part(layout)
    return gather_logits(logits_apply(embed, x[:, -1:], cfg.final_softcap, head),
                         head), aux


def prefill_dense(cfg: ArchConfig, params, cache, tokens, *, aux_embeds=None,
                  tiered=None, ep_axes=None, layout=None, cache_layout=None):
    """Single-pass dense prefill: :func:`decode_step` over each prompt
    column in turn (``aux_embeds`` passed to each), filling the cache and
    keeping the last logits (the prompt runs once).  Returns ``(last logits (B, V) f32, cache,
    streams)``; ``streams["router"]`` stacks the per-step router streams on
    a leading prompt axis, (S, G, n_moe, B, 1, k), or is None.  ``layout``
    and ``cache_layout`` as :func:`decode_step`'s."""
    tokens = torch.as_tensor(tokens)
    routers, logits = [], None
    for j in range(tokens.shape[1]):
        logits, cache, streams = decode_step(
            cfg, params, cache, tokens[:, j:j + 1], aux_embeds=aux_embeds,
            return_streams=True, tiered=tiered, ep_axes=ep_axes, layout=layout,
            cache_layout=cache_layout)
        routers.append(streams["router"])
    router = torch.stack(routers) if routers[0] is not None else None
    return logits[:, -1], cache, {"router": router}


# ---------------------------------------------------------------------------
# content-addressed page install (cross-request KV reuse, DESIGN.md §12)
# ---------------------------------------------------------------------------

def reuse_eligible(cfg: ArchConfig) -> bool:
    """True when a lane's whole per-position decode state is carried by the
    KV slow store alone — the precondition for fast-forwarding a fresh lane
    over slow-store pages (DESIGN.md §12): one attention position in the
    pattern, no recurrent blocks, no dense prologue."""
    recurrent = any(k in RECURRENT_KINDS for k in cfg.pattern)
    prologue = bool(cfg.moe and cfg.moe.n_dense_prologue)
    return len(cfg.pattern) == 1 and not recurrent and not prologue


def install_pages(cache, lane: int, slot_ids, rows: torch.Tensor, *, dk: int,
                  page_t: int, new_pos: int) -> None:
    """Fast-forward one lane's ring to ``new_pos`` by installing complete KV
    pages, in place: ``rows`` (G, n, T, hkv, dk+dv) [K | V] payload for
    ring slots ``slot_ids``.  Bitwise equal to streaming the same tokens:
    installed slots hold full pages and the new current slot's fill is
    zeroed (at a page boundary ``cur_slot`` has already advanced onto an
    empty slot).  Only the lane's own slots and counters are written; the
    ring is the pattern's first, as :func:`reuse_eligible` asks."""
    entry = next(c for c in cache["blocks"] if "page_len" in c)
    n_slots = entry["page_len"].shape[-1]
    slots = torch.as_tensor(np.asarray(slot_ids), dtype=torch.long,
                            device=entry["page_len"].device)
    entry["k_pages"][:, lane, slots] = rows[..., :dk].to(entry["k_pages"].dtype)
    entry["v_pages"][:, lane, slots] = rows[..., dk:].to(entry["v_pages"].dtype)
    entry["page_len"][:, lane, slots] = page_t
    cur = (new_pos // page_t) % n_slots
    entry["cur_slot"][:, lane] = cur
    entry["page_len"][:, lane, cur] = 0
    cache["pos"][lane] = new_pos


# ---------------------------------------------------------------------------
# sampling — temperature / nucleus over the lane substrate (DESIGN.md §9)
# ---------------------------------------------------------------------------

def fold_lane_keys(keys: torch.Tensor, idx) -> torch.Tensor:
    """Per-lane key derivation: fold each lane's (2,) request key with its
    emitted-token index (``jax.random.fold_in`` over the lanes)."""
    return prng.fold_in(keys, idx)


def nucleus_logits(logits: torch.Tensor, *, temperature: float,
                   top_p: float = 1.0) -> torch.Tensor:
    """The float32 scores a draw takes: ``logits`` tempered — multiplied by
    the float32 reciprocal of ``temperature``, as XLA compiles the
    reference's division by a constant — and, with ``top_p < 1``,
    nucleus-filtered: the smallest prefix of descending-probability tokens
    whose mass reaches ``top_p`` stays (the top-1 token always does), the
    rest is -inf."""
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        temperature, dtype=torch.float32)
    scaled = logits.float() * inv.to(logits.device)
    if top_p < 1.0:
        desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p              # mass BEFORE this token
        cutoff = torch.where(keep, desc, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled >= cutoff, scaled, -torch.inf)
    return scaled


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, *,
                  temperature: float = 0.0, top_p: float = 1.0) -> torch.Tensor:
    """Per-lane token sampling: (L, V) logits and (L, 2) threefry keys.
    ``temperature <= 0`` is the exact argmax (keys unused); otherwise
    ``jax.random.categorical``'s draw over :func:`nucleus_logits`, bit for
    bit in its random bits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(keys, nucleus_logits(logits, temperature=temperature,
                                                 top_p=top_p))
