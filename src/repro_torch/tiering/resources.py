"""The built-in tiered resources the port serves: paged KV and vocab rows
(DESIGN.md §3.2, §3.3).

Port of ``repro/tiering/resources.py``; the experts resource comes with the
MoE archs.
"""
from __future__ import annotations

import torch

from repro_torch.tiering.resource import ResourceSpec, StreamResource, register_resource

EMBED_ROWS_PER_PAGE = 64


def _subsample(pages: torch.Tensor, cap: int) -> torch.Tensor:
    """Deterministic stride subsampling to the NeoProf line-rate block size."""
    if pages.shape[0] > cap:
        pages = pages[:: pages.shape[0] // cap][:cap]
    return pages


@register_resource("kv")
class KVPagesResource(StreamResource):
    """Paged-KV cache: a page is hot if it carries attention mass.

    The stream is the set of resident page ids whose share of the step's
    softmax mass — exported by the paged-attention kernel — reaches
    ``mass_threshold``: the pages the model actually pulled from.
    """

    def __init__(self, spec: ResourceSpec, mass_threshold: float = 0.02):
        super().__init__(spec)
        self.mass_threshold = mass_threshold

    def encode_stream(self, page_mass: torch.Tensor,
                      page_ids: torch.Tensor) -> torch.Tensor:
        """(P,) per-page softmax mass + ids -> ids with cold pages masked -1."""
        total = torch.clamp_min(page_mass.sum(), 1e-30)
        keep = page_mass / total >= self.mass_threshold
        return torch.where(keep, page_ids.to(torch.int32), -1).reshape(-1)


@register_resource("embeddings")
class EmbedRowsResource(StreamResource):
    """Vocab tables: the access stream is the model's own input, a token's
    page its row-block ``token // rows_per_page`` (-1 tokens stay -1)."""

    def __init__(self, spec: ResourceSpec,
                 rows_per_page: int = EMBED_ROWS_PER_PAGE):
        super().__init__(spec)
        self.rows_per_page = rows_per_page

    def encode_stream(self, tokens: torch.Tensor) -> torch.Tensor:
        pages = torch.div(tokens.reshape(-1), self.rows_per_page,
                          rounding_mode="floor").to(torch.int32)
        return _subsample(pages, self.spec.stream_cap)
