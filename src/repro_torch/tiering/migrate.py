"""The migration data plane: real byte movement behind ``apply_migration``.

Port of ``repro/tiering/migrate.py``.  A resource that binds payload data
gets a :class:`TierBuffers` set (DESIGN.md §8):

  * ``fast``: ``(num_slots, *row_shape)`` — promoted copies, on the device,
    always in the resource's native dtype;
  * ``slow``: ``(num_pages, *row_shape)`` — the full backing store in the
    resource's wire format (:mod:`repro_torch.tiering.codec`, DESIGN.md
    §14).  For a CUDA resource it lives in pinned host memory (the slow
    tier of DESIGN.md §7, as the reference's ``pinned_host`` memory kind);
    on the CPU the split is logical;
  * ``scale``: ``(num_pages,)`` float32 per-row scales under the ``int8``
    codec (``None`` otherwise), beside the payload in the same memory.

Rows cross the link as they are stored: a slow read copies each payload
row straight from the pinned store to the device (its scales through a
pinned staging buffer) and decodes there; a write or a demotion encodes on
the device and moves the wire format down.  A read touches the slow store
only for the ids that miss the fast tier, each distinct id once.  Each
daemon epoch applies one copy (:func:`migrate`): victims are re-encoded
back to their old slow pages, then the promoted pages are decoded into the
freed fast slots.  Unlike the reference's
donated functional copies, the verbs update the buffers IN PLACE (the
fast buffer is the only copy the device holds) and return the same
:class:`TierBuffers`.  The asynchronous plane (DESIGN.md §15) stages an
epoch's promoted rows on a side CUDA stream instead (:func:`issue_migrate`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.tiering import codec as codec_lib


class TierBuffers(NamedTuple):
    """Payload buffers for one resource: fast copies over a slow store."""

    fast: torch.Tensor   # (num_slots, *row_shape) — native dtype, device
    slow: torch.Tensor   # (num_pages, *row_shape) — full store, wire format
    scale: torch.Tensor | None = None   # (num_pages,) float32 — int8 only


def row_bytes(buffers: TierBuffers) -> int:
    """WIRE bytes of one page row (the migration byte unit): the stored
    dtype's bytes, plus the float32 scale under the ``int8`` codec."""
    n = buffers.slow[0].numel() * buffers.slow.element_size()
    if buffers.scale is not None:
        n += buffers.scale.element_size()
    return n


def place_slow(x: torch.Tensor, device) -> torch.Tensor:
    """Place a backing store in the slow tier of ``device``: pinned host
    memory for a CUDA device, the tensor itself on the CPU."""
    if torch.device(device).type != "cuda":
        return x.to(device)
    x = x.cpu()
    return x if x.is_pinned() else x.pin_memory()


def init_buffers(slow_data: torch.Tensor, num_slots: int, codec: str = "none",
                 *, device="cuda") -> TierBuffers:
    """Build the buffer set around a native-dtype payload: the store is
    encoded to the codec's wire format where the payload lies, and placed
    in the slow tier with its scales."""
    payload, scale = codec_lib.encode_store(codec, slow_data)
    slow = place_slow(payload, device)
    if scale is not None:
        scale = place_slow(scale, device)
    fast = torch.zeros((num_slots,) + tuple(slow.shape[1:]),
                       dtype=slow_data.dtype, device=device)
    return TierBuffers(fast=fast, slow=slow, scale=scale)


def segment_page_ids(segment: int, n_tokens: int, page_t: int,
                     pages_per_seq: int,
                     table: np.ndarray | None = None) -> np.ndarray:
    """Global page ids of a request's first ``n_tokens`` worth of KV pages:
    ``ceil(n_tokens / page_t)`` pages of its segment from ``segment *
    pages_per_seq`` on, the final (possibly partial) page included.
    ``table`` is the lane's copy-on-write page-table row (local page ->
    pool gid, -1 = private): shared pool pages resolve through it, as the
    read path does (DESIGN.md §12/§13)."""
    n_pages = -(-max(n_tokens, 0) // page_t)
    local = np.arange(min(n_pages, pages_per_seq), dtype=np.int64)
    gids = segment * pages_per_seq + local
    if table is not None:
        tabled = np.asarray(table, np.int64)[local]
        gids = np.where(tabled >= 0, tabled, gids)
    return gids


def _host(x) -> np.ndarray:
    """Small index vectors to the host (the daemon's verbs are host-side)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _scale_at(scale: torch.Tensor | None, ids: np.ndarray):
    """Per-row scales for a gathered id batch (None under scale-less codecs)."""
    return None if scale is None else _gather(scale, ids)


def _gather(store: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
    """Rows ``ids`` of a slow-tier tensor, still in the slow tier: into a
    pinned staging buffer when the store is pinned."""
    idx = torch.as_tensor(ids, dtype=torch.long).reshape(-1)
    if not store.is_pinned():
        return store[idx.to(store.device)]
    rows = torch.empty((idx.numel(),) + tuple(store.shape[1:]),
                       dtype=store.dtype, pin_memory=True)
    return torch.index_select(store, 0, idx, out=rows)


def _slow_rows(slow: torch.Tensor, scale: torch.Tensor | None,
               ids: np.ndarray, device, out_dtype) -> torch.Tensor:
    """Slow rows ``ids`` moved to ``device`` in their wire format and decoded
    there.  From a pinned store each row is copied straight to the device,
    one asynchronous copy a row (no staging gather on the host: a kimi-k2
    expert row is 88 MB); from any other store, one gather."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    if slow.is_pinned():
        payload = torch.empty((ids.size,) + tuple(slow.shape[1:]),
                              dtype=slow.dtype, device=device)
        for j, i in enumerate(ids.tolist()):
            payload[j].copy_(slow[i], non_blocking=True)
    else:
        payload = slow[torch.as_tensor(ids, device=slow.device)].to(device)
    sc = _scale_at(scale, ids)
    if sc is not None:
        sc = sc.to(device, non_blocking=True)
    return codec_lib.decode_rows(payload, sc, out_dtype)


def _scatter(store: torch.Tensor, ids: np.ndarray, rows: torch.Tensor) -> None:
    """Write rows into a slow-tier tensor (blocking device-to-host copy)."""
    idx = torch.as_tensor(ids, dtype=torch.long, device=store.device)
    store[idx] = rows.to(store.device, store.dtype)


def _store_rows(buffers: TierBuffers, ids: np.ndarray, rows: torch.Tensor,
                codec: str) -> None:
    """Encode native rows where they lie and write the wire format (payload
    and scales) to slow pages ``ids`` — the reference's jitted write path,
    hence the scale by the reciprocal of 127."""
    payload, sc = codec_lib.encode_rows(codec, rows, by_reciprocal=True)
    _scatter(buffers.slow, ids, payload)
    if buffers.scale is not None:
        _scatter(buffers.scale, ids, sc)


def migrate(buffers: TierBuffers, promoted, victims, evicted,
            codec: str = "none") -> tuple[TierBuffers, int, int]:
    """Apply one promotion batch: ``promoted[i]`` is decoded into fast slot
    ``victims[i]`` after the slot's previous occupant ``evicted[i]`` is
    re-encoded back down (-1 = no-op lane everywhere).  Returns the
    buffers and the promoted / demoted row counts actually moved."""
    codec_lib.check_codec(codec)
    promoted, victims, evicted = _host(promoted), _host(victims), _host(evicted)
    ok = (promoted >= 0) & (victims >= 0)
    ev_ok = ok & (evicted >= 0)
    fast, n_pages = buffers.fast, buffers.slow.shape[0]
    # gather the promoted rows BEFORE the write-back (a page promoted in this
    # batch is never also evicted in it, but the order documents it); a page
    # id past the store reads its last row and its write-back is dropped,
    # still counted, as in the reference's jitted copy (ROADMAP C4)
    up = _slow_rows(buffers.slow, buffers.scale,
                    np.minimum(promoted[ok], n_pages - 1), fast.device,
                    fast.dtype)
    down = ev_ok & (evicted < n_pages)
    slots_ev = torch.as_tensor(victims[down], dtype=torch.long, device=fast.device)
    _store_rows(buffers, evicted[down], fast[slots_ev], codec)
    fast[torch.as_tensor(victims[ok], dtype=torch.long, device=fast.device)] = up
    return buffers, int(ok.sum()), int(ev_ok.sum())


def fill_slots(buffers: TierBuffers, slots: np.ndarray, pages: np.ndarray) -> None:
    """Fast slots ``slots`` take slow pages ``pages``, decoded on the device
    (a page past the store reads its last row, ROADMAP C4)."""
    fast = buffers.fast
    fast[torch.as_tensor(slots, device=fast.device)] = _slow_rows(
        buffers.slow, buffers.scale,
        np.minimum(pages, buffers.slow.shape[0] - 1), fast.device, fast.dtype)


def read_rows(fast: torch.Tensor, slow: torch.Tensor, slots: torch.Tensor,
              page_ids: torch.Tensor, scale=None) -> torch.Tensor:
    """Serve a batch of page reads: the fast copy when resident, else the
    slow row decoded on the device.  Only the missed ids are read from the
    slow store, each distinct id once.  Rows for invalid page ids (< 0)
    read slow page 0 — callers mask them."""
    slots = slots.to(fast.device).long()
    row_shape = tuple(fast.shape[1:])
    flat = slots.reshape(-1)
    out = fast[flat.clamp_min(0)]
    miss = np.flatnonzero(_host(flat) < 0)
    if miss.size:
        ids = _host(torch.where(page_ids >= 0, page_ids, 0)).reshape(-1)[miss]
        uniq, inv = np.unique(ids, return_inverse=True)
        inv = inv.reshape(-1)
        rows = _slow_rows(slow, scale, uniq, fast.device, fast.dtype)
        if not np.array_equal(inv, np.arange(inv.size)):
            rows = rows[torch.as_tensor(inv, device=fast.device)]
        out[torch.as_tensor(miss, device=fast.device)] = rows
    return out.reshape(tuple(slots.shape) + row_shape)


def lookup_rows(fast: torch.Tensor, slow: torch.Tensor,
                page_slot: torch.Tensor, page_ids, scale=None) -> torch.Tensor:
    """Placement lookup + dual-tier gather for ``page_ids`` of any shape."""
    page_ids = torch.as_tensor(page_ids, dtype=torch.long,
                               device=page_slot.device)
    slots = torch.where(page_ids >= 0, page_slot[page_ids.clamp_min(0)], -1)
    return read_rows(fast, slow, slots, page_ids, scale=scale)


def write_rows(buffers: TierBuffers, page_ids, slots, rows: torch.Tensor,
               codec: str = "none") -> TierBuffers:
    """Refresh page payloads in BOTH tiers: the slow store always takes the
    write, encoded to the wire format; promoted pages (``slots[i] >= 0``)
    get their native fast copy refreshed too.  -1 page ids are dropped."""
    ids, slots = _host(page_ids), _host(slots)
    keep = ids >= 0
    _store_rows(buffers, ids[keep], rows[torch.as_tensor(keep, device=rows.device)],
                codec)
    hot = keep & (slots >= 0)
    fast = buffers.fast
    fast[torch.as_tensor(slots[hot], dtype=torch.long, device=fast.device)] = \
        rows[torch.as_tensor(hot, device=rows.device)].to(fast.dtype)
    return buffers


def pages_to_rows(k_pages: torch.Tensor, v_pages: torch.Tensor) -> torch.Tensor:
    """Ring layout (G, L, S, T, hkv, d) -> page-row layout (L*S, G, T, hkv,
    dk+dv): the [K | V] rows the KV store holds."""
    rows = torch.cat([k_pages, v_pages], dim=-1).movedim(0, 2)
    return rows.reshape((-1,) + tuple(rows.shape[2:]))


def write_pages(buffers: TierBuffers, page_ids, slots, k_pages, v_pages,
                codec: str = "none") -> TierBuffers:
    """Bulk KV-page write: flush paged-ring slots (G, L, S, T, hkv, d) into
    the tier store; ``page_ids`` is the (L*S,) slot -> page map (-1 =
    unchanged/dropped slot), ``slots`` its placement lookup."""
    return write_rows(buffers, page_ids, slots,
                      pages_to_rows(k_pages, v_pages), codec=codec)


# -- async data plane (DESIGN.md §15) ---------------------------------------
#
# An asynchronous epoch is the promotion copy ONLY.  The reference produces
# a whole second fast buffer (a non-donated gather) and commits by pointer
# swap; here only the epoch's promoted rows are staged: they cross the link
# and are decoded on a side CUDA stream into a staging buffer, a CUDA event
# recorded after them is the readiness token, and the commit scatters them
# into the live fast buffer at the victim slots on the compute stream.
# That is bitwise the reference's swap: a promotion changes only the victim
# slots, so a page outside them holds the same slot in the committed and
# the in-flight table and the committed write verbs keep it coherent, a
# write to a page being evicted lands in a slot the commit overwrites, and
# a write to a page promoted in flight is replayed onto its staging row by
# the ``refresh_*`` verbs below, on the side stream after the issue's
# copies.  The demotion write-back is elided (every fast row equals its
# decoded slow row under the write-both-tiers rule); the caller still meters
# its bytes.  On the CPU there is no stream: the copy runs at issue and the
# token (None) is always ready.


def _on_side(stream):
    """Run what follows on the side ``stream``, after all the work queued
    so far on the compute stream (which produced the rows it reads), or
    inline on the CPU (``stream`` None)."""
    if stream is None:
        return contextlib.nullcontext()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    return torch.cuda.stream(stream)


def _used_on(stream, *tensors) -> None:
    """Tell the caching allocator that the side ``stream`` uses tensors the
    compute stream made (their memory is not reused before it is done).
    Index tensors are made there too: a pageable copy to the device on the
    side stream would wait for the epoch's copies."""
    if stream is not None:
        for t in tensors:
            t.record_stream(stream)


def _mark(stream, token) -> None:
    """(Re-)record the epoch's token after the work just queued on the side
    stream, so that the commit waits for it too."""
    if stream is not None:
        token.record(stream)


def issue_migrate(buffers: TierBuffers, promoted, victims, stream=None):
    """Dispatch one epoch's promotion copy without blocking: the rows of the
    promoted pages cross to the device on ``stream`` (None on the CPU) and
    are decoded there.  Returns ``(rows, slots, token)``: the staged rows,
    the victim fast slot of each (host int64), and the readiness token (a
    CUDA event recorded after the copies, None on the CPU).  A page id past
    the store reads its last row (ROADMAP C4), as :func:`migrate` does."""
    promoted, victims = _host(promoted), _host(victims)
    ok = (promoted >= 0) & (victims >= 0)
    fast, n_pages = buffers.fast, buffers.slow.shape[0]
    token = None
    with _on_side(stream):
        rows = _slow_rows(buffers.slow, buffers.scale,
                          np.minimum(promoted[ok], n_pages - 1), fast.device,
                          fast.dtype)
        if stream is not None:
            token = torch.cuda.Event()
            token.record(stream)
    return rows, victims[ok].astype(np.int64), token


def token_ready(token) -> bool:
    """Non-blocking readiness probe of an issued epoch's token."""
    return token is None or token.query()


def wait_token(token) -> None:
    """Block the host until an issued epoch's copy has landed (a forced
    commit; the caller meters the wait as ``stall_s``)."""
    if token is not None:
        token.synchronize()


def commit_rows(fast: torch.Tensor, rows: torch.Tensor, slots: np.ndarray,
                token) -> None:
    """Commit a staged epoch: scatter its rows into ``fast`` at their victim
    slots on the compute stream, ordered after the token even when a probe
    has already seen it ready."""
    if slots.size == 0:
        return
    if token is not None:
        cur = torch.cuda.current_stream(fast.device)
        cur.wait_event(token)
        rows.record_stream(cur)
    fast[torch.as_tensor(slots, device=fast.device)] = rows


def _staged(slot_row: np.ndarray, slots) -> tuple[np.ndarray, np.ndarray]:
    """(write mask, staging row of each kept write) for in-flight ``slots``:
    only a write to a page the epoch promotes has a staging row."""
    slots = _host(slots).reshape(-1)
    row = np.where(slots >= 0, slot_row[np.maximum(slots, 0)], -1)
    keep = row >= 0
    return keep, row[keep]


def refresh_rows(staging: torch.Tensor, slot_row: np.ndarray, slots,
                 rows: torch.Tensor, stream=None, token=None) -> None:
    """Replay an owner write onto the in-flight epoch (native dtype, no slow
    store touch: the committed write verb already encoded there): rows whose
    page the epoch promotes land on their staging rows, on the side stream
    after the issue's copies.  ``slots`` is the lookup under the in-flight
    placement table, ``slot_row`` maps a fast slot to its staging row."""
    keep, at = _staged(slot_row, slots)
    if at.size == 0:
        return
    # selected on the compute stream: a copy the ring's next step cannot touch
    src = rows[torch.as_tensor(keep, device=rows.device)].to(staging.device,
                                                             staging.dtype)
    idx = torch.as_tensor(at, device=staging.device)
    with _on_side(stream):
        _used_on(stream, src, idx)
        staging[idx] = src
    _mark(stream, token)


def refresh_pages(staging: torch.Tensor, slot_row: np.ndarray, slots, k_pages,
                  v_pages, stream=None, token=None) -> None:
    """Bulk-flush analogue of :func:`refresh_rows` for KV ring views."""
    refresh_rows(staging, slot_row, slots, pages_to_rows(k_pages, v_pages),
                 stream, token)


def refresh_copy(staging: torch.Tensor, slot_row: np.ndarray,
                 buffers: TierBuffers, src_ids, dst_slots, stream=None,
                 token=None) -> None:
    """:func:`copy_rows` replay onto the in-flight epoch: the destinations
    the epoch promotes take their source rows re-decoded from the slow
    store.  The rows are gathered on the host at once, so a later write to
    a source page cannot reach the copy."""
    src = _host(src_ids).reshape(-1)
    keep, at = _staged(slot_row, np.where(src >= 0, _host(dst_slots), -1))
    if at.size == 0:
        return
    ids = np.maximum(src[keep], 0)
    wire = _gather(buffers.slow, ids)
    sc = _scale_at(buffers.scale, ids)
    idx = torch.as_tensor(at, device=staging.device)
    with _on_side(stream):
        _used_on(stream, idx)
        rows = codec_lib.decode_rows(
            wire.to(staging.device, non_blocking=True),
            None if sc is None else sc.to(staging.device, non_blocking=True),
            staging.dtype)
        staging[idx] = rows
    _mark(stream, token)


def copy_rows(buffers: TierBuffers, src_ids, dst_ids, dst_slots) -> TierBuffers:
    """Duplicate page payloads store to store — the content-addressed
    publish verb (DESIGN.md §12).  The wire format travels verbatim (payload
    and scale, no decode and re-encode), so a publish costs the stored
    bytes; destinations currently promoted (``dst_slots[i] >= 0``) get
    their fast copy refreshed, decoded on the device.  -1 in either id
    array drops that pair."""
    src, dst, dslot = _host(src_ids), _host(dst_ids), _host(dst_slots)
    valid = (src >= 0) & (dst >= 0)
    src, dst, dslot = src[valid], dst[valid], dslot[valid]
    rows = _gather(buffers.slow, src)          # gathered BEFORE the scatter
    sc = _scale_at(buffers.scale, src)
    _scatter(buffers.slow, dst, rows)
    if sc is not None:
        _scatter(buffers.scale, dst, sc)
    hot = dslot >= 0
    if hot.any():
        fast = buffers.fast
        fast[torch.as_tensor(dslot[hot], dtype=torch.long, device=fast.device)] = \
            _slow_rows(buffers.slow, buffers.scale, dst[hot], fast.device,
                       fast.dtype)
    return buffers
