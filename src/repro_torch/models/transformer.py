"""Parameter init for every family the reference serves, the training
forward and loss, and the encoder's forward (port of
``repro/models/transformer.py``): the dense GQA family, the
mixture-of-experts family, with GQA (kimi-k2) or MLA attention and the multi-token-prediction head's
parameters (deepseek-v3), the hybrid family (zamba2: Mamba2 blocks and one
shared attention block), the recurrent ``ssm`` family (xlstm: mLSTM and
sLSTM blocks), the ``vlm`` family (llama-3.2-vision: self-attention blocks
and gated ``cross`` blocks over an image's patch embeddings) and the
``audio`` family (whisper: a bidirectional encoder, then ``dec`` blocks of
self and cross attention).  The dense family covers llama3.2-3b and the
layer features of qwen1.5-4b (QKV biases), stablelm-1.6b (LayerNorm) and
gemma2-27b (``rms+1`` norms, post-norms, GeGLU, and the ``("attn_local",
"attn_global")`` pattern).

Layers are stacked by *pattern group*: ``params["blocks"][i]`` holds pattern
position i with every leaf shaped ``(G, ...)``, the reference's layout, so
weights converted from the reference (:mod:`repro_torch.convert`) drop in.
A MoE arch's dense prologue layers are ``params["prologue"]``, a list of
unstacked blocks whose FFN is ``dense_ff`` wide.  A recurrent block is
``{"ln", "mix"}`` (its norm and its Mamba2, mLSTM or sLSTM mixer); a
``shared_attn`` position holds ``{}``, its weights living once in
``params["shared_attn"]``, an unstacked attention block that every group
reuses.  A ``cross`` or ``dec`` block adds its cross attention's norm
``lnx`` and weights ``xattn``, and a ``cross`` block its gate ``xgate``
(float32, drawn as zero as the reference's: with the reference's init an
image changes no logit).  An encoder arch's blocks are
``params["encoder"]``, a list of unstacked self-attention blocks, and its
final norm ``params["enc_norm"]``.  ``params["mtp"]`` (an unstacked block,
the (2d, d) projection and a norm) is the multi-token-prediction head,
which only :func:`train_loss` runs.  Weights are drawn on the target
device from a seeded ``torch.Generator`` with the reference's init scales;
the numbers differ from ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.ckpt.manager import tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import entry_axes, per_group
from repro_torch.models.attention import (cross_apply, gqa_apply, gqa_init,
                                          mla_apply, mla_init)
from repro_torch.models.layers import (DTYPE, _normal, apply_norm,
                                       cross_entropy, embed_apply, embed_init,
                                       logits_apply, make_norm, mlp_apply,
                                       mlp_init)
from repro_torch.models.mamba2 import mamba2_apply, mamba2_init
from repro_torch.models.moe import moe_apply_ep, moe_init
from repro_torch.models.xlstm import (mlstm_apply, mlstm_init, slstm_apply,
                                      slstm_init)

# the dense family's attention block kinds (gemma2 alternates local and global)
DENSE_KINDS = {"attn", "attn_local", "attn_global"}
# the block kinds of the hybrid (zamba2) and recurrent (xlstm) families, and
# the kinds whose decode state is O(1) recurrent state, not a KV cache
HYBRID_KINDS = {"mamba", "shared_attn"}
SSM_KINDS = {"mlstm", "slstm"}
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")
# the vision family's kinds (self-attention and gated cross attention)
VLM_KINDS = {"attn", "cross"}


def check_ported(cfg: ArchConfig) -> None:
    """The port runs the dense GQA family (patterns of ``attn``,
    ``attn_local`` and ``attn_global`` blocks), the MoE family (pattern
    ``("moe",)`` behind dense prologue layers), whose attention is GQA or
    MLA and which may carry the multi-token head's parameters, the hybrid
    family (patterns of ``mamba`` and ``shared_attn`` blocks), the ``ssm``
    family (patterns of ``mlstm`` and ``slstm`` blocks), the ``vlm`` family
    (patterns of ``attn`` and ``cross`` blocks) and the ``audio`` family
    (pattern ``("dec",)`` behind an encoder), with any of the reference's
    norms (rms, rms+1, ln) and MLPs (swiglu, geglu, gelu); raise for
    anything else (a family's blocks outside it, an encoder outside the
    audio family, MLA or the multi-token head outside the MoE family)."""
    plain = cfg.moe is None and cfg.mla is None and not cfg.mtp
    kinds = set(cfg.pattern)
    dense = cfg.family == "dense" and plain and kinds <= DENSE_KINDS
    moe = cfg.family == "moe" and cfg.moe is not None and kinds == {"moe"}
    hybrid = cfg.family == "hybrid" and plain and cfg.ssm is not None \
        and kinds <= HYBRID_KINDS
    ssm = cfg.family == "ssm" and plain and kinds <= SSM_KINDS
    vlm = cfg.family == "vlm" and plain and kinds <= VLM_KINDS
    audio = cfg.family == "audio" and plain and kinds == {"dec"} \
        and cfg.encoder_layers > 0
    if not (dense or moe or hybrid or ssm or vlm or audio) \
            or (cfg.encoder_layers and not audio):
        raise NotImplementedError(
            f"arch {cfg.name!r} ({cfg.family}, pattern {cfg.pattern}) is not yet "
            "ported to repro_torch: only the dense GQA family, the MoE family "
            "(GQA or MLA), the Mamba2 hybrid, the xLSTM family, the vision "
            "family and the encoder-decoder family are")


def _mixer(gen, cfg: ArchConfig, kind: str, groups: int, device):
    """A recurrent block's mixer: Mamba2, mLSTM or sLSTM."""
    if kind == "mamba":
        s = cfg.ssm
        return mamba2_init(gen, cfg.d_model, d_state=s.d_state, expand=s.expand,
                           headdim=s.headdim, d_conv=s.d_conv,
                           n_groups=s.n_groups, groups=groups, device=device)
    if kind == "mlstm":
        return mlstm_init(gen, cfg.d_model, n_heads=cfg.mlstm_heads,
                          groups=groups, device=device)
    return slstm_init(gen, cfg.d_model, groups=groups, device=device)


def _block(gen, cfg: ArchConfig, kind: str, groups: int, device):
    """One block of ``kind`` (a dense attention kind, "moe", "attn_dense"
    for a MoE arch's prologue, a recurrent kind, "shared_attn", whose
    position holds no weights, "cross" or "dec", or "enc" for an encoder
    block); ``groups > 0`` stacks that many on a leading axis."""
    d = cfg.d_model
    lead = (groups,) if groups else ()
    if kind == "shared_attn":
        return {}
    if kind in RECURRENT_KINDS:
        return {"ln": make_norm(cfg.norm, lead + (d,), device),
                "mix": _mixer(gen, cfg, kind, groups, device)}
    p = {"ln1": make_norm(cfg.norm, lead + (d,), device),
         "ln2": make_norm(cfg.norm, lead + (d,), device)}
    if cfg.post_norm:
        p["pn1"] = make_norm(cfg.norm, lead + (d,), device)
        p["pn2"] = make_norm(cfg.norm, lead + (d,), device)
    if cfg.mla is not None:
        p["attn"] = mla_init(gen, d, cfg.n_heads, groups=groups, device=device,
                             **dataclasses.asdict(cfg.mla))
    else:
        p["attn"] = gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             groups=groups, bias=cfg.qkv_bias, dtype=DTYPE,
                             device=device)
    if kind == "moe":
        mc = cfg.moe
        p["ffn"] = moe_init(gen, d, mc.n_experts, mc.expert_ff,
                            shared_f=mc.shared_ff, groups=groups, device=device)
        if mc.bias_free_balance:
            p["router_bias"] = torch.zeros(lead + (mc.n_experts,),
                                           dtype=torch.float32, device=device)
    else:
        width = cfg.moe.dense_ff if kind == "attn_dense" else cfg.d_ff
        p["ffn"] = mlp_init(gen, d, width, cfg.mlp, lead=lead, device=device)
    if kind in ("cross", "dec"):
        p["lnx"] = make_norm(cfg.norm, lead + (d,), device)
        p["xattn"] = gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              groups=groups, bias=cfg.qkv_bias, dtype=DTYPE,
                              device=device)
    if kind == "cross":
        p["xgate"] = torch.zeros(lead + (1,), dtype=torch.float32, device=device)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda"):
    """The params tree of ``cfg`` drawn from ``seed`` on ``device``; on
    ``"meta"`` the shapes and dtypes alone (``jax.eval_shape``'s
    counterpart)."""
    check_ported(cfg)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    # draw order: the body, the shared attention block, the prologue, the
    # encoder, the embedding, then the MTP head
    params = {"blocks": [_block(gen, cfg, kind, cfg.n_groups, device)
                         for kind in cfg.pattern]}
    if "shared_attn" in cfg.pattern:
        params["shared_attn"] = _block(gen, cfg, "attn", 0, device)
    if cfg.moe and cfg.moe.n_dense_prologue:
        params["prologue"] = [_block(gen, cfg, "attn_dense", 0, device)
                              for _ in range(cfg.moe.n_dense_prologue)]
    if cfg.encoder_layers:
        params["encoder"] = [_block(gen, cfg, "enc", 0, device)
                             for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = make_norm(cfg.norm, (cfg.d_model,), device)
    params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, device=device)
    if cfg.mtp:
        d = cfg.d_model
        params["mtp"] = {
            "block": _block(gen, cfg, "attn_dense" if cfg.moe else "attn", 0,
                            device),
            "proj": _normal((2 * d, d), (2 * d) ** -0.5, gen, device, DTYPE),
            "norm": make_norm(cfg.norm, (d,), device)}
    params["final_norm"] = make_norm(cfg.norm, (cfg.d_model,), device)
    return params


# -- the training forward (full sequence) ----------------------------------------

def _attn_block(p, cfg: ArchConfig, kind: str, x, aux, ep_axes=None, parts=None):
    """One attention block over the whole sequence (the reference's
    ``_apply_attn_block``): self-attention (MLA where the arch has it but
    in a ``cross`` block; bidirectional for the encoder's ``enc_self``),
    then a ``cross`` block's gated cross attention over
    ``aux["aux_embeds"]`` or a ``dec`` block's over ``aux["enc_out"]``,
    then the MLP or, in a ``moe`` block, the routed experts (expert-parallel
    under ``ep_axes``).  ``parts`` ({"attn", "ffn", "xattn"}) partitions
    the self-attention, the MLP or the shared expert and the cross
    attention over 'model'.  Returns (x, the block's router ids (B, S, k)
    or None)."""
    parts = parts or {}
    h = apply_norm(cfg.norm, p["ln1"], x)
    if cfg.mla is not None and kind != "cross":
        o = mla_apply(p["attn"], h, h=cfg.n_heads, rope_theta=cfg.rope_theta,
                      part=parts.get("attn"), **dataclasses.asdict(cfg.mla))
    else:
        o = gqa_apply(p["attn"], h, h=cfg.n_heads, hkv=cfg.n_kv_heads,
                      dh=cfg.head_dim, rope_theta=cfg.rope_theta,
                      causal=kind != "enc_self",
                      window=cfg.window if kind == "attn_local" else 0,
                      softcap=cfg.attn_softcap, scale=cfg.attn_scale,
                      part=parts.get("attn"))
    if cfg.post_norm:
        o = apply_norm(cfg.norm, p["pn1"], o)
    x = x + o
    kv_src = aux.get("aux_embeds") if kind == "cross" else \
        aux.get("enc_out") if kind == "dec" else None
    if kv_src is not None:
        xo = cross_apply(p["xattn"], apply_norm(cfg.norm, p["lnx"], x), kv_src,
                         h=cfg.n_heads, hkv=cfg.n_kv_heads, dh=cfg.head_dim,
                         part=parts.get("xattn"))
        x = x + ((torch.tanh(p["xgate"]) * xo.float()).to(x.dtype)
                 if kind == "cross" else xo)
    h2 = apply_norm(cfg.norm, p["ln2"], x)
    stream = None
    if kind == "moe":
        y, stream, _ = moe_apply_ep(p["ffn"], h2, cfg.moe.top_k,
                                    bias=p.get("router_bias"), ep_axes=ep_axes,
                                    part=parts.get("ffn"))
    else:
        y = mlp_apply(p["ffn"], h2, cfg.mlp, part=parts.get("ffn"))
    if cfg.post_norm:
        y = apply_norm(cfg.norm, p["pn2"], y)
    return x + y, stream


def _apply_block(p, shared, cfg: ArchConfig, kind: str, x, aux, ep_axes=None,
                 parts=None):
    """One block of the body: a recurrent mixer behind its norm and
    residual, the shared attention block, or an attention block.  ``parts``
    partitions the mixer ({"mix"}), or the shared block's or the attention
    block's attention and MLP ({"attn", "ffn"}), over 'model'."""
    parts = parts or {}
    if kind in RECURRENT_KINDS:
        h = apply_norm(cfg.norm, p["ln"], x)
        part = parts.get("mix")
        if kind == "mamba":
            s = cfg.ssm
            y = mamba2_apply(p["mix"], h, headdim=s.headdim, n_groups=s.n_groups,
                             d_state=s.d_state, chunk=s.chunk, part=part)
        elif kind == "mlstm":
            y = mlstm_apply(p["mix"], h, n_heads=cfg.mlstm_heads, part=part)
        else:
            y = slstm_apply(p["mix"], h, part=part)
        return x + y, None
    if kind == "shared_attn":
        return _attn_block(shared, cfg, "attn", x, aux, ep_axes, parts)
    return _attn_block(p, cfg, kind, x, aux, ep_axes, parts)


def _unbind_groups(block, groups: int) -> list:
    """A group-stacked block (every leaf (G, ...)) as G per-group blocks.
    Each leaf is unbound once, so the backward stacks its G gradients once
    instead of adding a full (G, ...) gradient per group."""
    parts = [torch.unbind(leaf, 0) for leaf in tree_leaves(block)]
    return [tree_unflatten(block, [p[g] for p in parts]) for g in range(groups)]


def _top(params, layout, keys=None):
    """``params`` with every leaf outside ``params["blocks"]`` (or under
    ``keys`` alone) gathered under ``layout`` (one autograd function); the
    blocks stay stored, and a subtree the layout splits over 'model' keeps
    the rank's block there."""
    if layout is None:
        return params
    top = {k: v for k, v in params.items()
           if k != "blocks" and (keys is None or k in keys)}
    specs = {k: layout.specs[k] for k in top}
    return dict(params, **layout.gather(top, specs))


def _head_part(layout):
    """The rank's Part of the vocab-parallel embedding and head, or None."""
    return None if layout is None else layout.part_of("embed")


def _parts(layout, block: str) -> dict:
    """The {"attn", "ffn", "mix", "xattn"} parts of the block at ``block``
    (a path such as "prologue/0", "shared_attn", "encoder/1"), none without
    a layout."""
    return {} if layout is None else layout.parts(block)


def _body_parts(cfg: ArchConfig, layout, i: int) -> dict:
    """The parts of pattern position i: a ``shared_attn`` position computes
    with the shared block's."""
    return _parts(layout, "shared_attn" if cfg.pattern[i] == "shared_attn"
                  else f"blocks/{i}")


def model_split(cfg: ArchConfig, specs, n_model: int = 1) -> set:
    """The subtrees of ``specs`` (a params spec tree over a mesh whose
    'model' axis has ``n_model`` ranks) that compute split over 'model',
    for every arch :func:`check_ported` admits: "embed" where the table's
    vocab is split; each block's "attn" (under ``blocks/i``,
    ``prologue/i`` and ``mtp/block``) where its column weights' outputs
    and ``wo``'s rows all are (MLA: ``wq_a``, ``wq_b``, ``wkv_a`` and
    ``wkv_b``, and its heads divide the ranks); its "ffn" where the MLP's
    (or a MoE block's shared expert's) column and row matrices all are;
    and "mtp/proj" where its columns are; each recurrent position's "mix"
    (``blocks/i/mix``) where its column and row matrices are split and its
    heads divide the ranks (Mamba2: ``in_proj``, ``conv_w`` and
    ``out_proj``, its heads and its B | C columns, a rank's heads whole
    groups or in one; mLSTM: ``wq``, ``wk``,
    ``wv``, ``ogate`` and ``wo``, its heads dividing the ranks or the ranks
    a head dividing its width; sLSTM: ``wz``, ``wi``, ``wf``, ``wo_gate``
    and ``wo``), the shared attention block's ``shared_attn/attn`` and
    ``shared_attn/ffn``, a ``cross`` or ``dec`` block's cross attention
    ``blocks/i/xattn`` where its column weights' outputs and ``wo``'s rows
    all are (the core's form is chosen at the call,
    :func:`repro_torch.models.attention.core_form`), and each encoder
    block's ``encoder/j/attn`` and ``encoder/j/ffn`` by the tests of
    "attn" and "ffn"."""

    def split(spec, d):
        return "model" in entry_axes(spec[d])

    def mix(m, kind):
        n = n_model
        if kind == "mamba":
            s = cfg.ssm
            heads = cfg.d_model * s.expand // s.headdim
            hl, hpg = heads // n, heads // s.n_groups
            ok = heads % n == 0 and (2 * s.n_groups * s.d_state) % n == 0 \
                and (hl % hpg == 0 or hpg % hl == 0)
            cols, row = ("in_proj", "conv_w"), "out_proj"
        elif kind == "mlstm":
            h, dh = cfg.mlstm_heads, cfg.d_model // cfg.mlstm_heads
            ok = h % n == 0 or (n % h == 0 and dh % (n // h) == 0)
            cols, row = ("wq", "wk", "wv", "ogate"), "wo"
        else:
            ok, cols, row = True, ("wz", "wi", "wf", "wo_gate"), "wo"
        return ok and all(split(m[w], -1) for w in cols) and split(m[row], 1)

    def attn(a, lead, gqa=False):
        mla = cfg.mla is not None and not gqa
        cols = ("wq_a", "wq_b", "wkv_a", "wkv_b") if mla else ("wq", "wk", "wv")
        heads = not mla or cfg.n_heads % n_model == 0
        return heads and all(split(a[w], -1) for w in cols) and split(a["wo"], lead)

    def ffn(f, lead):
        cols, row = (("sh_gate", "sh_in"), "sh_out") if "router" in f else \
            (("w_gate", "w_in"), "w_out")
        return row in f and all(split(f[w], -1) for w in cols if w in f) \
            and split(f[row], lead)

    out = {"embed"} if split(specs["embed"]["table"], 0) else set()
    blocks = []
    for i, (kind, b) in enumerate(zip(cfg.pattern, specs["blocks"])):
        if kind in RECURRENT_KINDS:
            if mix(b["mix"], kind):
                out.add(f"blocks/{i}/mix")
        elif kind != "shared_attn":
            blocks.append((f"blocks/{i}", b, 1))
            if "xattn" in b and attn(b["xattn"], 1, gqa=True):
                out.add(f"blocks/{i}/xattn")
    if "shared_attn" in specs:
        blocks.append(("shared_attn", specs["shared_attn"], 0))
    blocks += [(f"prologue/{i}", b, 0) for i, b in enumerate(specs.get("prologue", []))]
    blocks += [(f"encoder/{j}", b, 0) for j, b in enumerate(specs.get("encoder", []))]
    if "mtp" in specs:
        blocks.append(("mtp/block", specs["mtp"]["block"], 0))
        if split(specs["mtp"]["proj"], -1):
            out.add("mtp/proj")
    for path, b, lead in blocks:
        if attn(b["attn"], lead):
            out.add(f"{path}/attn")
        if ffn(b["ffn"], lead):
            out.add(f"{path}/ffn")
    return out


def forward(cfg: ArchConfig, params, tokens, *, aux_embeds=None,
            remat: bool = True, ep_axes=None, layout=None):
    """tokens (B, S) -> (final hidden states (B, S, D), aux).  ``aux``
    holds ``token_stream``, the encoder's ``enc_out`` (an encoder arch, which
    runs its encoder here over ``aux_embeds``) or the ``aux_embeds``
    themselves, and for a MoE arch ``router_streams`` (G, n_moe_in_group,
    B, S, k) int32, the reference's layout (the prologue adds none).  With
    ``remat`` each pattern group runs under non-reentrant activation
    checkpointing, its router ids an output of the checkpointed function so
    that the recompute in the backward appends nothing.

    Over a mesh ``params`` are the rank's stored blocks and ``layout``
    (:class:`repro_torch.dist.sharding.Layout`) gathers them: the leaves
    outside the body once, each pattern group's inside its checkpoint, so
    that remat gathers again and runs the partitioned layers' collectives
    again; the subtrees the layout splits over 'model' compute the rank's
    share (the embedding, each block's attention and MLP or shared expert,
    a MoE arch's dense prologue and MTP head, each recurrent mixer, zamba2's
    shared attention block, each cross attention and encoder block);
    ``ep_axes`` runs the MoE layers expert-parallel."""
    return _forward(cfg, _top(params, layout), tokens, aux_embeds, remat,
                    ep_axes, layout)


def _forward(cfg: ArchConfig, params, tokens, aux_embeds, remat, ep_axes, layout):
    x = embed_apply(params["embed"], tokens, part=_head_part(layout))
    if cfg.embed_scale:
        x = (x.float() * cfg.d_model ** 0.5).to(x.dtype)
    aux = {"token_stream": tokens}
    if cfg.encoder_layers and aux_embeds is not None:
        aux["enc_out"] = _encode(cfg, params, aux_embeds, ep_axes, layout)
    elif aux_embeds is not None:
        aux["aux_embeds"] = aux_embeds
    for j, lp in enumerate(params.get("prologue", [])):
        x, _ = _attn_block(lp, cfg, "attn_dense", x, aux, ep_axes,
                           _parts(layout, f"prologue/{j}"))
    shared = params.get("shared_attn")
    gspecs = None if layout is None else per_group(layout.specs["blocks"])

    def group_body(x, gp):
        if layout is not None:
            gp = layout.gather(gp, gspecs)
        streams = []
        for i, kind in enumerate(cfg.pattern):
            x, stream = _apply_block(gp[i], shared, cfg, kind, x, aux, ep_axes,
                                     _body_parts(cfg, layout, i))
            if stream is not None:
                streams.append(stream)
        return x, (torch.stack(streams) if streams else None)

    g = cfg.n_groups
    per_pos = [_unbind_groups(b, g) for b in params["blocks"]]
    streams = []
    for gi in range(g):
        gp = [pos[gi] for pos in per_pos]
        if remat:
            x, st = checkpoint(group_body, x, gp, use_reentrant=False)
        else:
            x, st = group_body(x, gp)
        if st is not None:
            streams.append(st)
    if streams:
        aux["router_streams"] = torch.stack(streams)
    return apply_norm(cfg.norm, params["final_norm"], x), aux


def train_loss(cfg: ArchConfig, params, batch, *, remat: bool = True,
               ep_axes=None, layout=None):
    """The training loss of ``batch`` (``tokens``, ``labels`` (B, S), and
    optionally ``aux_embeds`` and ``loss_mask``): the cross entropy of the
    tied-embedding logits, plus 0.3 x the multi-token head's (which
    predicts t+2 from h_t and the embedding of token t+1, both rolled by
    -1).  ``ep_axes`` and ``layout`` as in :func:`forward`.  Returns (loss,
    (metrics, aux))."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("loss_mask")
    params = _top(params, layout)
    x, aux = _forward(cfg, params, tokens, batch.get("aux_embeds"), remat,
                      ep_axes, layout)
    part = _head_part(layout)
    loss = cross_entropy(logits_apply(params["embed"], x, cfg.final_softcap, part),
                         labels, mask, part)
    metrics = {"loss": loss}
    if cfg.mtp:
        mp = params["mtp"]
        emb_next = embed_apply(params["embed"], torch.roll(tokens, -1, dims=1), part)
        h2 = _mtp_proj(mp["proj"], torch.cat([x, emb_next.to(x.dtype)], dim=-1),
                       None if layout is None else layout.part_of("mtp/proj"))
        h2, _ = _attn_block(mp["block"], cfg, "attn_dense" if cfg.moe else "attn",
                            h2, {}, ep_axes, _parts(layout, "mtp/block"))
        h2 = apply_norm(cfg.norm, mp["norm"], h2)
        mtp_loss = cross_entropy(
            logits_apply(params["embed"], h2, cfg.final_softcap, part),
            torch.roll(labels, -1, dims=1), mask, part)
        loss = loss + 0.3 * mtp_loss
        metrics["mtp_loss"] = mtp_loss
        metrics["loss"] = loss
    return loss, (metrics, aux)


def _mtp_proj(w, x, part=None):
    """The MTP head's (2d, d) projection: whole, or with ``part`` the rank's
    output columns gathered whole over its ranks (their gradients the
    same on every rank: the residual stream after it is replicated)."""
    if part is None:
        return x @ w
    return col.gather(col.enter(x, part.group) @ w, -1, part.group, reduce=False)


def encode(cfg: ArchConfig, params, aux_embeds, *, ep_axes=None, layout=None):
    """The encoder stack (whisper): frame embeddings (B, S, D) -> the
    encoder's output, which serving computes once at prefill and every
    decode step's ``dec`` blocks attend over.  Over a mesh ``params`` are
    the rank's stored blocks and ``layout`` gathers the encoder's leaves,
    each encoder block computing its share over 'model' where the layout
    splits it (:func:`forward`)."""
    return _encode(cfg, _top(params, layout, ("encoder", "enc_norm")), aux_embeds,
                   ep_axes, layout)


def _encode(cfg: ArchConfig, params, aux_embeds, ep_axes, layout):
    enc = aux_embeds
    for j, lp in enumerate(params["encoder"]):
        enc, _ = _attn_block(lp, cfg, "enc_self", enc, {}, ep_axes,
                             _parts(layout, f"encoder/{j}"))
    return apply_norm(cfg.norm, params["enc_norm"], enc)
