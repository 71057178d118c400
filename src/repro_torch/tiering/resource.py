"""TieredResource — the one API every consumer of slow memory speaks.

Port of ``repro/tiering/resource.py``.  A resource adapts itself to the
tiering layer with ``encode_stream(*observation) -> page-id stream`` (pure;
-1 entries are padding) and ``apply_migration(promoted, victims)`` (a
host-side hook; resources that declare ``row_shape``/``row_dtype`` get
their bytes moved by the data plane, :mod:`repro_torch.tiering.migrate`).
A :class:`ResourceSpec` is the single source of sizing truth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.neoprof import NeoProfParams
from repro_torch.core.sketch import SketchParams
from repro_torch.core.tiering import TierParams
from repro_torch.tiering import codec as codec_lib


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """Sizing for one tiered resource — the only place geometry is declared.

    ``row_shape``/``row_dtype`` declare the payload of one page for the data
    plane; ``row_shape=None`` means placement/telemetry only.
    """

    name: str
    n_pages: int                  # logical pages in the slow tier
    hot_slots: int                # fast-tier capacity (pages)
    quota_pages: int = 64         # promotions per migration interval
    sketch_width: int = 1 << 14
    sketch_depth: int = 2
    stream_cap: int = 1 << 14     # max page ids fed to NeoProf per step
    touch_cap: int = 4096         # max page ids fed to tier accounting per step
    row_shape: tuple | None = None   # payload shape of ONE page (data plane)
    row_dtype: str = "bfloat16"      # payload dtype name (a torch dtype)
    slow_codec: str = "none"         # slow-store wire format (tiering.codec)

    def prof_params(self) -> NeoProfParams:
        return NeoProfParams(sketch=SketchParams(
            width=self.sketch_width, depth=self.sketch_depth))

    def tier_params(self) -> TierParams:
        return TierParams(num_pages=self.n_pages, num_slots=self.hot_slots,
                          quota_pages=self.quota_pages)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.row_dtype)

    @property
    def row_bytes(self) -> int:
        """NATIVE payload bytes per page (0 when no data plane is declared)."""
        if self.row_shape is None:
            return 0
        return math.prod(self.row_shape) * self.dtype.itemsize

    @property
    def wire_row_bytes(self) -> int:
        """Bytes one page costs on the migration wire under ``slow_codec``."""
        if self.row_shape is None:
            return 0
        return codec_lib.wire_row_bytes(self.slow_codec, self.row_shape,
                                        self.dtype)

    @property
    def quota_bytes(self) -> int:
        """Per-epoch byte budget: each promotion moves one row up and at
        most one written-back row down."""
        return 2 * self.quota_pages * self.wire_row_bytes


@runtime_checkable
class TieredResource(Protocol):
    """What a consumer of tiered memory must provide."""

    spec: ResourceSpec

    def encode_stream(self, *observation) -> torch.Tensor:
        """Pure: model-side observation -> (N,) int32 page-id stream, -1 pad."""
        ...

    def apply_migration(self, promoted_pages, victim_slots) -> None:
        """Host-side data movement for one promotion batch (may be a no-op)."""
        ...


class StreamResource:
    """Convenience base: a spec whose bytes the data plane moves, so the
    resource's own migration hook has nothing to do."""

    def __init__(self, spec: ResourceSpec):
        self.spec = spec

    def apply_migration(self, promoted_pages, victim_slots) -> None:
        pass


# Registry: resource kind -> class, so owners look resources up by name.
_REGISTRY: dict[str, type] = {}


def register_resource(kind: str):
    """Class decorator: register a TieredResource implementation by name."""

    def deco(cls):
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls

    return deco


def resource_kinds() -> list[str]:
    return sorted(_REGISTRY)


def make_resource(kind: str, *args, **kwargs) -> TieredResource:
    if kind not in _REGISTRY:
        raise KeyError(
            f"unknown tiered resource {kind!r}; known: {resource_kinds()}")
    return _REGISTRY[kind](*args, **kwargs)
