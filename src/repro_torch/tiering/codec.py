"""Row codecs: the slow tier's wire format (DESIGN.md §14).

Port of ``repro/tiering/codec.py`` for the ``none`` codec: the slow store
holds rows in their native dtype, so encode and decode are the identity (a
dtype cast on decode) and a page costs its native bytes on the wire.  The
reference's ``fp32`` and ``int8`` codecs are not yet ported; naming one
raises.
"""
from __future__ import annotations

import math

import torch

CODECS = ("none",)
NOT_YET_PORTED = ("fp32", "int8")


def check_codec(codec: str) -> str:
    if codec in NOT_YET_PORTED:
        raise NotImplementedError(
            f"slow-tier codec {codec!r} is not yet ported to repro_torch; "
            f"ported: {CODECS}")
    if codec not in CODECS:
        raise KeyError(f"unknown slow-tier codec {codec!r}; known: {CODECS}")
    return codec


def encode_rows(codec: str, rows: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Encode ``(K, *row_shape)`` native rows for the slow store:
    -> ``(payload, scale)``; the ``none`` codec has no scale."""
    check_codec(codec)
    return rows, None


def decode_rows(payload: torch.Tensor, scale: torch.Tensor | None,
                out_dtype) -> torch.Tensor:
    """Decode slow-store rows back to ``out_dtype`` (the fast tier's dtype)."""
    if scale is not None:
        raise NotImplementedError("scaled (int8) slow stores are not yet ported")
    return payload.to(out_dtype)


def wire_row_bytes(codec: str, row_shape: tuple, row_dtype) -> int:
    """Bytes ONE page row costs on the migration wire / at rest."""
    check_codec(codec)
    return math.prod(row_shape) * row_dtype.itemsize
