"""The three built-in tiered resources: KV pages, MoE experts and vocab rows
(DESIGN.md §3.1-§3.3).

Port of ``repro/tiering/resources.py``: each is a stream encoder, and the
serve engine binds each one's payload (flushed KV pages, expert weight rows,
vocab row-blocks) so the daemon's epochs move real bytes.
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


@register_resource("experts")
class ExpertStreamResource(StreamResource):
    """MoE expert weights: the stream is the router's token->expert ids,
    page = group * n_experts + expert."""

    def __init__(self, spec: ResourceSpec, n_experts: int):
        super().__init__(spec)
        self.n_experts = n_experts

    def encode_stream(self, router_streams: torch.Tensor) -> torch.Tensor:
        """(G, n_moe, ..., k) router expert ids -> flat page stream; negative
        entries are padding (masked lanes) and stay -1.  As in the
        reference, the leading axis is taken for the group axis whatever it
        is: a prefill chunk's (C, G, n_moe, B, 1, k) stream numbers its pages
        by chunk column, past the resource's pages (ROADMAP C4)."""
        g = router_streams.shape[0]
        group_ids = torch.arange(g, dtype=torch.int32,
                                 device=router_streams.device).reshape(
            (g,) + (1,) * (router_streams.dim() - 1))
        router = router_streams.to(torch.int32)
        pages = torch.where(router >= 0, group_ids * self.n_experts + router,
                            -1).reshape(-1)
        return _subsample(pages, self.spec.stream_cap)


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
