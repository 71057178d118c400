"""Mixture-of-Experts on one device: the top-k router, expert dispatch, the
NeoMem-tiered expert read and the load-balancing loss (port of
``repro/models/moe.py``, its single-device functions).

The router's token->expert ids are also the NeoMem profiling stream: the
serve engine feeds them to the "experts" resource (page = group * n_experts
+ expert), and the train step to its in-step NeoProf sketch.  The ways to
apply a layer:

  * :func:`moe_apply_ep` — capacity dispatch over the dense (E, D, F)
    weights (the reference's expert-parallel body), the forward of serving
    and of the train step, on one device or expert-parallel over a mesh; it
    carries gradients
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

Expert parallelism (:class:`EPContext`): over a mesh the expert stacks are
split over ``expert_axis`` (each rank owns ``E / n`` experts) and may be
split over ``fsdp_axis`` on their dim 1 (ZeRO-3 storage, gathered for the
layer).  Every rank of an ``expert_axis`` group routes the same tokens,
dispatches those routed to its own experts (ids offset by its coordinate
times ``E / n``) and the partial outputs are summed over the group, with
the autograd rules of :mod:`repro_torch.dist.collectives`.  The tokens are
the rank's own (the train step's data-parallel rows, or every token where
the caller runs replicated); ``dp_axes`` names the axes they arrive split
over.  The NeoMem-tiered serving arm (``"residency"`` params: only the hot
experts resident, plus a per-interval fetch buffer of cold ones) runs with
and without a mesh.  Over 'model' the shared expert is tensor-parallel
(``part``: ``sh_gate``/``sh_in`` column blocks, ``sh_out`` row blocks,
the parts summed) while the router stays replicated.

The expert products are plain matrix products here, as the reference
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.models.layers import DTYPE, _normal, mlp_apply
from repro_torch.tiering.migrate import lookup_rows


def moe_init(generator: torch.Generator, d, e, f, *, shared_f: int = 0,
             groups: int = 0, dtype=DTYPE, device="cuda"):
    """Router (float32) and expert weights with the reference's init scales;
    ``groups > 0`` stacks ``groups`` layers on a leading axis.  The expert
    stacks of a full-width model are drawn a slice at a time
    (:func:`repro_torch.models.layers._normal`)."""
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


def _dispatch(x, gate, lid, keep_pre, n_loc: int, cap: int, experts, combine=None):
    """Capacity dispatch of the assignments ``keep_pre`` to the ``n_loc``
    local experts ``lid`` (the first ``cap`` of each in token order), the
    expert products, and the gated combine over each token's k
    assignments; ``combine`` sums the float32 partial outputs over the
    ranks.  -> y (B,S,D) in x's dtype."""
    b, s, d = x.shape
    t, k = gate.shape
    rank = _rank_in_bins(torch.where(keep_pre, lid, n_loc), n_loc)
    keep = keep_pre & (rank < cap)
    se = torch.where(keep, lid, 0).long()
    sc = torch.where(keep, rank, 0).long()
    tok = torch.arange(t * k, device=x.device) // k
    contrib = torch.where(keep[:, None], x.reshape(t, d)[tok],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    # the reference's .at[se, sc].add: kept lanes own distinct (expert, rank)
    # cells, and the dropped lanes all add zeros to cell (0, 0), so the
    # accumulation is exact whatever order it runs in
    xe = torch.zeros((n_loc, cap, d), dtype=x.dtype, device=x.device)
    xe.index_put_((se, sc), contrib, accumulate=True)
    wg, wi, wo = experts
    h = _silu_glu(xe, wg, wi, "ecd,edf->ecf")
    ye = torch.einsum("ecf,efd->ecd", h, wo)               # (E_loc, C, D)
    y_asn = ye[se, sc].float() * (keep[:, None] * gate.reshape(t * k)[:, None])
    y = y_asn.reshape(t, k, d).sum(dim=1)
    if combine is not None:
        y = combine(y)
    return y.reshape(b, s, d).to(x.dtype)


def _ep_local_body(x, router_w, bias, wg, wi, wo, *, k: int, cap: int,
                   midx: int = 0, combine=None):
    """Capacity dispatch of x (B,S,D) to the experts of the (E_loc,D,F)
    weights, which are experts ``midx * E_loc`` onwards of the router's
    (the reference's expert-parallel body; ``combine`` is its psum over the
    expert axis).  Returns (y (B,S,D), expert ids (B,S,k))."""
    e_loc = wg.shape[0]
    b, s, d = x.shape
    t = b * s
    logits = x.float().reshape(t, d) @ router_w
    sel, gate_src = _scores(logits, bias)
    idx = _top_k(sel, k)                                   # (T, k)
    gate = _gates(gate_src, idx)
    lid = idx.reshape(t * k).to(torch.int32) - midx * e_loc
    mine = (lid >= 0) & (lid < e_loc)
    y = _dispatch(x, gate, lid, mine, e_loc, cap, (wg, wi, wo), combine)
    return y, idx.reshape(b, s, k).to(torch.int32)


def _ep_resident_body(x, router_w, bias, res_map, wg, wi, wo, fw_g, fw_i, fw_o,
                      fetch_ids, *, k: int, cap: int, midx: int = 0, combine=None):
    """NeoMem-tiered serving dispatch: only the HOT experts are resident
    (``wg/wi/wo``: this rank's (E_hot_loc, D, F) slots of the fast tier,
    ``res_map`` (E,) each expert's global hot slot or -1), plus this rank's
    fetch buffer of cold experts (``fw_*``, ids ``fetch_ids``) brought in
    under the migration quota.  A token routed to an expert neither
    resident nor fetched takes the shared expert alone.  Selection is by
    ``sigmoid(logits) + bias``, as the reference's.  Returns (y, ids)."""
    e_hot_loc, n_fetch = wg.shape[0], fw_g.shape[0]
    b, s, d = x.shape
    t = b * s
    logits = x.float().reshape(t, d) @ router_w
    sig = torch.sigmoid(logits)
    sel = sig + (bias if bias is not None else 0.0)
    idx = _top_k(sel, k)
    gate = _gates(sig if bias is not None else torch.softmax(logits, dim=-1), idx)
    eid = idx.reshape(t * k)
    slot = res_map[eid].to(torch.int32)
    mine_hot = (slot >= 0) & (torch.div(slot, e_hot_loc, rounding_mode="floor") == midx)
    fmatch = eid[:, None] == fetch_ids.long()[None, :]         # (T*k, n_fetch)
    fslot = fmatch.int().argmax(dim=1).to(torch.int32)          # the first match
    is_fetched = fmatch.any(dim=1) & (slot < 0)
    n_loc = e_hot_loc + n_fetch
    lid = torch.where(mine_hot, slot - midx * e_hot_loc,
                      torch.where(is_fetched, e_hot_loc + fslot, n_loc))
    experts = (torch.cat([wg, fw_g]), torch.cat([wi, fw_i]), torch.cat([wo, fw_o]))
    y = _dispatch(x, gate, lid, mine_hot | is_fetched, n_loc, cap, experts, combine)
    return y, idx.reshape(b, s, k).to(torch.int32)


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


@dataclasses.dataclass(frozen=True)
class EPContext:
    """Expert-parallel execution context: the experts split over
    ``expert_axis``, their dim 1 over ``fsdp_axis`` where stored so (the
    layer gathers it), the tokens split over ``dp_axes`` by the caller.
    A layer costs one gather of its expert weights over the data axis and
    one sum of the partial outputs over the expert axis."""

    mesh: Any
    expert_axis: str = "model"
    fsdp_axis: str | None = "data"
    dp_axes: tuple = ("data",)
    capacity_factor: float = 2.0


def moe_apply_ep(p, x, k: int, *, bias=None, ep_axes: EPContext | None = None,
                 part=None):
    """One MoE layer over the dense expert weights, capacity-dispatched; on
    one device, or expert-parallel over ``ep_axes`` (``p``'s expert stacks
    then the rank's blocks).  ``"residency"`` params take the NeoMem-tiered
    serving arm.  ``part`` partitions the shared expert over 'model'
    (:func:`_shared_expert`; the router stays replicated).  Returns (y,
    expert ids (B,S,k), None)."""
    e = p["router"].shape[-1]
    b, s, d = x.shape
    combine, midx, router = None, 0, p["router"]
    if ep_axes is not None:
        mesh = ep_axes.mesh
        group = mesh.group(ep_axes.expert_axis)
        midx = mesh.coord(ep_axes.expert_axis)
        combine = lambda y: col.sum_parts(y, group)
        x_in, router = col.enter(x, group), col.enter(router, group)
    else:
        x_in = x
    if "residency" in p:
        # dispatch buffers sized to the expected load (x8 headroom), not to
        # the no-drop bound: with E_hot + fetch local experts a t*k capacity
        # would pad the expert products ~10x
        cap = min(b * s * k, max(64, int(8.0 * b * s * k / e)))
        y, idx = _ep_resident_body(
            x_in, router, bias, p["residency"], p["w_gate"], p["w_in"], p["w_out"],
            p["fetch_gate"], p["fetch_in"], p["fetch_out"], p["fetch_ids"],
            k=k, cap=cap, midx=midx, combine=combine)
        return y + _shared_expert(p, x, part), idx, None
    ws = (p["w_gate"], p["w_in"], p["w_out"])
    cf = 2.0
    if ep_axes is not None:
        cf = ep_axes.capacity_factor
        if ep_axes.fsdp_axis is not None and ws[0].shape[1] != d:
            fg = mesh.group(ep_axes.fsdp_axis)
            ws = tuple(col.gather(w, 1, fg, reduce=True) for w in ws)
    y, idx = _ep_local_body(x_in, router, bias, *ws, k=k,
                            cap=_capacity(b * s, k, e, cf), midx=midx,
                            combine=combine)
    return y + _shared_expert(p, x, part), idx, None


def moe_apply_tiered(p, x, k: int, *, bias=None, tier, group_id: int, part=None):
    """NeoMem-tiered MoE layer (DESIGN.md §10): each selected expert's
    ``[w_gate | w_in | w_out]`` row is read through the experts resource's
    placement table — its fast (device) copy when promoted, the slow store
    otherwise (a miss is slower, never wrong: the tiers are inclusive).
    ``tier`` is the resource's ``{"fast", "slow", "page_slot", "scale"}``
    view, ``group_id`` the layer group (page = group * n_experts + expert).
    ``part`` partitions the shared expert.  Returns (y, expert ids (B,S,k),
    router probs)."""
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
    return out + _shared_expert(p, x, part), idx, probs


def _shared_expert(p, x, part=None):
    """The shared expert, a SwiGLU MLP over every token (zeros where the
    layer has none); with ``part`` ``sh_gate``/``sh_in`` are the rank's
    column blocks and ``sh_out`` its row block, the parts summed."""
    if "sh_in" not in p:
        return torch.zeros_like(x)
    return mlp_apply({"w_gate": p["sh_gate"], "w_in": p["sh_in"],
                      "w_out": p["sh_out"]}, x, "swiglu", part)
