"""The built-in tiered resources the port serves: paged KV (DESIGN.md §3.2).

Port of ``repro/tiering/resources.py``, ``KVPagesResource`` only; the
expert and embedding resources are not yet ported.
"""
from __future__ import annotations

import torch

from repro_torch.tiering.resource import ResourceSpec, StreamResource, register_resource


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
