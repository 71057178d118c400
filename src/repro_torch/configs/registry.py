"""Architecture registry: arch id -> ArchConfig, for the archs the port runs.

The port serves all ten of the reference registry's architectures: the
dense decoders (llama3.2-3b, qwen1.5-4b, stablelm-1.6b and gemma2-27b), the
GQA MoE flagship (kimi-k2), the MLA MoE arch (deepseek-v3), the Mamba2
hybrid with shared attention (zamba2-2.7b), the attention-free xLSTM
(xlstm-1.3b), the vision decoder with gated cross attention
(llama-3.2-vision-11b) and the encoder-decoder whisper-base.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_v3_671b, gemma2_27b, kimi_k2_1t,
                                 llama32_3b, llama32_vision_11b, qwen15_4b,
                                 stablelm_1p6b, whisper_base, xlstm_1p3b,
                                 zamba2_2p7b)

ARCHS = ["llama3.2-3b", "kimi-k2-1t-a32b", "deepseek-v3-671b", "qwen1.5-4b",
         "stablelm-1.6b", "gemma2-27b", "zamba2-2.7b", "xlstm-1.3b",
         "llama-3.2-vision-11b", "whisper-base"]

# the reference's archs the port does not serve yet: none
NOT_YET_PORTED: tuple[str, ...] = ()

_MODULES = {"llama3.2-3b": llama32_3b, "kimi-k2-1t-a32b": kimi_k2_1t,
            "deepseek-v3-671b": deepseek_v3_671b, "qwen1.5-4b": qwen15_4b,
            "stablelm-1.6b": stablelm_1p6b, "gemma2-27b": gemma2_27b,
            "zamba2-2.7b": zamba2_2p7b, "xlstm-1.3b": xlstm_1p3b,
            "llama-3.2-vision-11b": llama32_vision_11b,
            "whisper-base": whisper_base}


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    """Reduced same-family config for CPU tests."""
    return _module(name).SMOKE_CONFIG


def list_archs():
    return list(ARCHS)
