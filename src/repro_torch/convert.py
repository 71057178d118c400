"""Bring the reference's weights and sketch seeds across, through numpy.

The tests start the port from the JAX model's exact weights and the JAX
daemon's exact H3 seeds, so nothing is re-drawn:

    np_params = jax.tree.map(np.asarray, params)       # on the JAX side
    params = params_from_jax(np_params, device="cpu")

bf16 leaves cross through a ``uint16`` view, because ``torch.from_numpy``
takes no ``ml_dtypes`` bfloat16 array.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_params, device="cuda"):
    """The reference's parameter pytree (numpy leaves, group-stacked (G, ...)
    blocks) as the port's nested dicts/lists of tensors on ``device``."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return type(np_params)(params_from_jax(v, device) for v in np_params)
    return _leaf(np_params, device)


def sketch_seeds_from_jax(np_seeds) -> torch.Tensor:
    """The reference sketch's (D, 30) H3 seeds as a CPU int32 tensor."""
    return torch.from_numpy(np.array(np_seeds, dtype=np.int32))
