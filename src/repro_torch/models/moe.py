"""Mixture-of-Experts on one device: the top-k router, expert dispatch, the
NeoMem-tiered expert read and the load-balancing loss (port of
``repro/models/moe.py``, its single-device functions).

The router's token->expert ids are also the NeoMem profiling stream: the
serve engine feeds them to the "experts" resource (page = group * n_experts
+ expert), and the train step to its in-step NeoProf sketch.  The ways to
apply a layer:

  * :func:`moe_apply_ep` — capacity dispatch over the dense (E, D, F)
    weights (the reference's expert-parallel body without its collectives),
    the forward of serving and of the train step; it carries gradients
    (the dispatch is an ``index_put`` with accumulation into a fresh zero
    buffer, the combine a gather);
  * :func:`moe_apply_dense` — every expert on every token, weighted by the
    routing mask (collective-free, O(E));
  * :func:`moe_apply_gather` — capacity dispatch by one-hot products
    (token-dropping, ``capacity_factor * T * k / E`` slots an expert);
  * :func:`moe_apply_tiered` — each token's top-k experts' flattened
    ``[w_gate | w_in | w_out]`` rows read through the experts resource's
    placement table: the fast (device) copy when promoted, the slow store
    otherwise.

The expert products are plain matrix products here, as the reference
computes them outside any Pallas kernel.  The EP-sharded paths
(``EPContext``, resident experts) wait for the distribution layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _normal
from repro_torch.models.layers import DTYPE
from repro_torch.tiering.migrate import lookup_rows


def moe_init(generator: torch.Generator, d, e, f, *, shared_f: int = 0,
             groups: int = 0, dtype=DTYPE, device="cuda"):
    """Router (float32) and expert weights with the reference's init scales;
    ``groups > 0`` stacks ``groups`` layers on a leading axis.  The expert
    stacks of a full-width model are drawn a slice at a time
    (:func:`repro_torch.models.attention._normal`)."""
    lead = (groups,) if groups else ()
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": _normal(lead + (d, e), s_in, generator, device, torch.float32),
        "w_gate": _normal(lead + (e, d, f), s_in, generator, device, dtype),
        "w_in": _normal(lead + (e, d, f), s_in, generator, device, dtype),
        "w_out": _normal(lead + (e, f, d), s_out, generator, device, dtype),
    }
    if shared_f > 0:
        p["sh_gate"] = _normal(lead + (d, shared_f), s_in, generator, device, dtype)
        p["sh_in"] = _normal(lead + (d, shared_f), s_in, generator, device, dtype)
        p["sh_out"] = _normal(lead + (shared_f, d), shared_f ** -0.5, generator,
                              device, dtype)
    return p


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, equal scores in
    index order — ``jax.lax.top_k``'s tie rule (``torch.topk`` has none)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _scores(logits: torch.Tensor, bias):
    """(selection scores, gate source): sigmoid + the balancing bias and the
    sigmoid itself with a bias, else the logits and their softmax."""
    if bias is not None:
        sig = torch.sigmoid(logits)
        return sig + bias, sig
    return logits, torch.softmax(logits, dim=-1)


def _gates(gate_src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    gate = torch.take_along_dim(gate_src, idx, dim=-1)
    return gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)


def router_topk(p, x, k: int, *, bias=None):
    """Returns (gates (B,S,k) f32 renormalised to sum 1, expert ids (B,S,k)
    int32, probs (B,S,E) f32 softmax of the router logits)."""
    logits = x.float() @ p["router"]
    sel, gate_src = _scores(logits, bias)
    idx = _top_k(sel, k)
    probs = torch.softmax(logits, dim=-1)
    return _gates(gate_src, idx), idx.to(torch.int32), probs


def _capacity(t: int, k: int, e: int, cf: float) -> int:
    """Expert capacity: exact (no drops) for small batches such as decode,
    ``cf * T * k / E`` for large ones."""
    if t * k <= 4096:
        return t * k
    return max(k, int(cf * t * k / e))


def _rank_in_bins(eids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Rank of each element among the earlier elements of its bin value
    (stable sort, O(N log N))."""
    n = eids.shape[0]
    order = torch.argsort(eids, stable=True)
    sorted_e = eids[order]
    start = torch.searchsorted(
        sorted_e, torch.arange(n_bins + 1, dtype=sorted_e.dtype,
                               device=eids.device))
    ar = torch.arange(n, dtype=torch.int32, device=eids.device)
    ranks_sorted = ar - start[sorted_e.long()].to(torch.int32)
    inv = torch.empty_like(ar)
    inv[order] = ar
    return ranks_sorted[inv.long()]


def _silu_glu(x, wg, wi, eq: str):
    return F.silu(torch.einsum(eq, x, wg)) * torch.einsum(eq, x, wi)


def _ep_local_body(x, router_w, bias, wg, wi, wo, *, k: int, cap: int):
    """Capacity dispatch of x (B,S,D) to the E experts of (E,D,F) weights:
    the reference's expert-parallel body on one device (no all-gather, no
    psum).  Returns (y (B,S,D), expert ids (B,S,k))."""
    e_loc = wg.shape[0]
    b, s, d = x.shape
    t = b * s
    logits = x.float().reshape(t, d) @ router_w
    sel, gate_src = _scores(logits, bias)
    idx = _top_k(sel, k)                                   # (T, k)
    gate = _gates(gate_src, idx)

    eid = idx.reshape(t * k).to(torch.int32)
    mine = (eid >= 0) & (eid < e_loc)
    rank = _rank_in_bins(torch.where(mine, eid, e_loc), e_loc)
    keep = mine & (rank < cap)
    se = torch.where(keep, eid, 0).long()
    sc = torch.where(keep, rank, 0).long()

    tok = torch.arange(t * k, device=x.device) // k
    contrib = torch.where(keep[:, None], x.reshape(t, d)[tok],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    # the reference's .at[se, sc].add: kept lanes own distinct (expert, rank)
    # cells, and the dropped lanes all add zeros to cell (0, 0), so the
    # accumulation is exact whatever order it runs in
    xe = torch.zeros((e_loc, cap, d), dtype=x.dtype, device=x.device)
    xe.index_put_((se, sc), contrib, accumulate=True)

    h = _silu_glu(xe, wg, wi, "ecd,edf->ecf")
    ye = torch.einsum("ecf,efd->ecd", h, wo)               # (E, C, D)

    y_asn = ye[se, sc].float() * (keep[:, None] * gate.reshape(t * k)[:, None])
    y = y_asn.reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d).to(x.dtype), idx.reshape(b, s, k).to(torch.int32)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in float32: an index outside [0, n) is all zeros."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).float()


def moe_apply_dense(p, x, k: int, *, bias=None):
    """Collective-free dispatch: every expert on every token, combined by
    the routing weights.  Returns (y, expert ids (B,S,k), router probs)."""
    e = p["router"].shape[1]
    gate, idx, probs = router_topk(p, x, k, bias=bias)
    comb = (_one_hot(idx, e) * gate[..., None]).sum(dim=-2)   # (B, S, E)
    h = _silu_glu(x, p["w_gate"], p["w_in"], "bsd,edf->bsef")
    y = torch.einsum("bsef,efd->bsed", h, p["w_out"])
    out = torch.einsum("bsed,bse->bsd", y.float(), comb).to(x.dtype)
    return out + _shared_expert(p, x), idx, probs


def moe_apply_gather(p, x, k: int, *, capacity_factor: float = 1.25, bias=None):
    """Capacity dispatch by one-hot products: each expert takes its first
    ``max(1, int(capacity_factor * T * k / E))`` assignments in token order
    and drops the rest.  Returns (y, expert ids (B,S,k), router probs)."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    gate, idx, probs = router_topk(p, x, k, bias=bias)
    xt = x.reshape(b * s, d)
    cap = max(1, int(capacity_factor * b * s * k / e))
    onehot = _one_hot(idx.reshape(b * s, k), e)               # (T, k, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)  # slot
    keep = pos < cap
    disp = onehot * keep[..., None]
    slot_oh = _one_hot(pos.to(torch.int32), cap)              # (T, k, C)
    xe = torch.einsum("td,tke,tkc->ecd", xt.float(), disp, slot_oh).to(x.dtype)
    h = _silu_glu(xe, p["w_gate"], p["w_in"], "ecd,edf->ecf")
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"])          # (E, C, D)
    y = torch.einsum("ecd,tke,tkc,tk->td", ye.float(), disp, slot_oh,
                     gate.reshape(b * s, k))
    return y.reshape(b, s, d).to(x.dtype) + _shared_expert(p, x), idx, probs


def aux_load_balance_loss(probs, idx, e: int, k: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e mean prob_e * the share
    of assignments to e."""
    me = probs.reshape(-1, e).mean(dim=0)
    ce = _one_hot(idx.reshape(-1, k), e).sum(dim=1).mean(dim=0) / k
    return e * (me * ce).sum()


def moe_apply_ep(p, x, k: int, *, bias=None, ep_axes=None):
    """One MoE layer over the dense expert weights, capacity-dispatched on
    this device.  Returns (y, expert ids (B,S,k), None)."""
    if ep_axes is not None or "residency" in p:
        raise NotImplementedError(
            "expert-parallel MoE dispatch (EPContext, resident experts) is not "
            "yet ported to repro_torch (ROADMAP item 10, the distribution layer)")
    b, s, _ = x.shape
    cap = _capacity(b * s, k, p["router"].shape[1], 2.0)
    y, idx = _ep_local_body(x, p["router"], bias, p["w_gate"], p["w_in"],
                            p["w_out"], k=k, cap=cap)
    return y + _shared_expert(p, x), idx, None


def moe_apply_tiered(p, x, k: int, *, bias=None, tier, group_id: int):
    """NeoMem-tiered MoE layer (DESIGN.md §10): each selected expert's
    ``[w_gate | w_in | w_out]`` row is read through the experts resource's
    placement table — its fast (device) copy when promoted, the slow store
    otherwise (a miss is slower, never wrong: the tiers are inclusive).
    ``tier`` is the resource's ``{"fast", "slow", "page_slot", "scale"}``
    view, ``group_id`` the layer group (page = group * n_experts + expert).
    Returns (y, expert ids (B,S,k), router probs)."""
    e = p["router"].shape[1]
    gate, idx, probs = router_topk(p, x, k, bias=bias)
    _, d, f = p["w_gate"].shape
    rows = lookup_rows(tier["fast"], tier["slow"], tier["page_slot"],
                       group_id * e + idx.long(),
                       scale=tier.get("scale"))           # (B, S, k, 3*d*f)
    rows = rows.to(p["w_gate"].dtype)
    wg = rows[..., : d * f].reshape(idx.shape + (d, f))
    wi = rows[..., d * f: 2 * d * f].reshape(idx.shape + (d, f))
    wo = rows[..., 2 * d * f:].reshape(idx.shape + (f, d))
    h = _silu_glu(x, wg, wi, "bsd,bskdf->bskf")
    y = torch.einsum("bskf,bskfd->bskd", h, wo)
    out = torch.einsum("bskd,bsk->bsd", y.float(), gate).to(x.dtype)
    return out + _shared_expert(p, x), idx, probs


def _shared_expert(p, x):
    if "sh_in" not in p:
        return torch.zeros_like(x)
    h = F.silu(x @ p["sh_gate"]) * (x @ p["sh_in"])
    return h @ p["sh_out"]
