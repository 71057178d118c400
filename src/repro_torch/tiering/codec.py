"""Row codecs: the slow tier's wire format (DESIGN.md §14).

Port of ``repro/tiering/codec.py``.  A codec decides how a resource's slow
store is encoded at rest, and so how many bytes every migration epoch,
flush and reuse-pool copy meters:

  * ``none`` — the native dtype (the default; the pre-codec data path);
  * ``fp32`` — rows upcast to float32 at rest: for bf16 rows numerically
    the identity, at 4 bytes an element;
  * ``int8`` — per-row symmetric quantization, ``scale = max|row| / 127``
    (float32, one per page row) and ``q = round(row / scale)`` as int8.

Decode dispatches on the payload's dtype and the presence of a scale, so
the read verbs need no codec name.  The arithmetic is the reference's op
for op in float32, so payloads and scales are bitwise the reference's, on
the CPU and on the card: ``q = round(x / scale)`` stays a division and
``torch.round`` rounds half to even as ``jnp.round`` does.  The scale's
``max / 127`` is a division where the reference runs eagerly (encoding a
store at bind time) and a multiplication by the float32 reciprocal of 127
where the reference runs under ``jax.jit`` (its write, flush and demotion
verbs), since XLA compiles a division by a constant that way; the callers
say which with ``by_reciprocal``.
"""
from __future__ import annotations

import math

import torch

CODECS = ("none", "fp32", "int8")

_SCALE_BYTES = 4        # one float32 scale per int8 page row


def check_codec(codec: str) -> str:
    if codec not in CODECS:
        raise KeyError(f"unknown slow-tier codec {codec!r}; known: {CODECS}")
    return codec


_INV_127 = torch.tensor(1.0) / torch.tensor(127.0)     # float32 reciprocal


def symmetric_scale(x: torch.Tensor, axes=None, *,
                    by_reciprocal: bool = False) -> torch.Tensor:
    """``max|x| / 127`` over ``axes`` (None = the whole tensor), guarded so
    an all-zero slice quantizes to q == 0 with scale 1 instead of 0/0;
    ``by_reciprocal`` multiplies by the float32 ``1 / 127`` instead."""
    a = x.float().abs()
    m = a.amax() if axes is None else a.amax(dim=axes)
    # the divisor is a tensor on m's device: CUDA divides by a CPU scalar as
    # a multiplication by its reciprocal
    scale = (m * _INV_127.to(m.device) if by_reciprocal
             else m / torch.tensor(127.0, device=m.device))
    return torch.where(scale > 0.0, scale, 1.0)


def quantize_int8(x: torch.Tensor, axes=None, *, by_reciprocal: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: -> (q int8, scale float32 reduced over ``axes``);
    ``|x| <= 127 * scale``, so the round never clips."""
    x = x.float()
    scale = symmetric_scale(x, axes, by_reciprocal=by_reciprocal)
    s = scale.reshape(tuple(scale.shape) + (1,) * (x.dim() - scale.dim()))
    return torch.round(x / s).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """``q * scale`` broadcast back over the quantized trailing axes."""
    s = scale.reshape(tuple(scale.shape) + (1,) * (q.dim() - scale.dim()))
    return (q.float() * s).to(out_dtype)


def encode_rows(codec: str, rows: torch.Tensor, *, by_reciprocal: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Encode ``(K, *row_shape)`` native rows for the slow store: ``int8``
    yields an int8 payload and a (K,) float32 scale, ``fp32`` a float32
    payload, ``none`` the rows themselves; the last two have no scale.
    ``by_reciprocal`` as in :func:`symmetric_scale` (the write verbs)."""
    check_codec(codec)
    if codec == "int8":
        return quantize_int8(rows, axes=tuple(range(1, rows.dim())),
                             by_reciprocal=by_reciprocal)
    if codec == "fp32":
        return rows.float(), None
    return rows, None


def decode_rows(payload: torch.Tensor, scale: torch.Tensor | None,
                out_dtype) -> torch.Tensor:
    """Decode slow-store rows back to ``out_dtype`` (the fast tier's dtype):
    an int8 payload against its per-row scales, anything else a cast."""
    if payload.dtype == torch.int8:
        if scale is None:
            raise ValueError("int8 slow store decoded without its scales")
        return dequantize_int8(payload, scale, out_dtype)
    return payload.to(out_dtype)


def encode_store(codec: str, slow_data: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Encode a whole ``(num_pages, *row_shape)`` backing store at bind time."""
    return encode_rows(codec, slow_data)


def wire_row_bytes(codec: str, row_shape: tuple, row_dtype) -> int:
    """Bytes ONE page row costs on the migration wire and at rest: int8
    pays 1 byte an element plus its float32 scale, fp32 4 bytes an
    element, none the native dtype."""
    check_codec(codec)
    if isinstance(row_dtype, str):
        row_dtype = getattr(torch, row_dtype)
    n = math.prod(row_shape)
    if codec == "int8":
        return n + _SCALE_BYTES
    if codec == "fp32":
        return n * 4
    return n * row_dtype.itemsize
