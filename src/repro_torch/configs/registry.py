"""Architecture registry: arch id -> ArchConfig, for the archs the port runs.

The reference registry lists ten architectures; the port serves the dense
decoders (llama3.2-3b, qwen1.5-4b, stablelm-1.6b and gemma2-27b), the GQA
MoE flagship (kimi-k2), the MLA MoE arch (deepseek-v3), the Mamba2 hybrid
with shared attention (zamba2-2.7b) and the attention-free xLSTM
(xlstm-1.3b) so far.  Asking for any other known arch raises, naming it as
not yet ported.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, gemma2_27b, kimi_k2_1t,
                                 llama32_3b, qwen15_4b, stablelm_1p6b,
                                 xlstm_1p3b, zamba2_2p7b)

ARCHS = ["llama3.2-3b", "kimi-k2-1t-a32b", "deepseek-v3-671b", "qwen1.5-4b",
         "stablelm-1.6b", "gemma2-27b", "zamba2-2.7b", "xlstm-1.3b"]

# the reference's other archs, which later slices port
NOT_YET_PORTED = ("llama-3.2-vision-11b", "whisper-base")

_MODULES = {"llama3.2-3b": llama32_3b, "kimi-k2-1t-a32b": kimi_k2_1t,
            "deepseek-v3-671b": deepseek_v3_671b, "qwen1.5-4b": qwen15_4b,
            "stablelm-1.6b": stablelm_1p6b, "gemma2-27b": gemma2_27b,
            "zamba2-2.7b": zamba2_2p7b, "xlstm-1.3b": xlstm_1p3b}


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
