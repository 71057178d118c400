"""Architecture registry: arch id -> ArchConfig, for the archs the port runs.

The reference registry lists ten architectures; the port serves only the
dense paged-KV arch of the main path so far.  Asking for any other known
arch raises, naming it as not yet ported.
"""
from __future__ import annotations

from repro_torch.configs import llama32_3b

ARCHS = ["llama3.2-3b"]

# the reference's other archs, which later slices port
NOT_YET_PORTED = (
    "llama-3.2-vision-11b", "zamba2-2.7b", "gemma2-27b", "stablelm-1.6b",
    "qwen1.5-4b", "whisper-base", "xlstm-1.3b", "kimi-k2-1t-a32b",
    "deepseek-v3-671b",
)

_MODULES = {"llama3.2-3b": llama32_3b}


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: {ARCHS}")
    raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    """Reduced same-family config for CPU tests."""
    return _module(name).SMOKE_CONFIG


def list_archs():
    return list(ARCHS)
