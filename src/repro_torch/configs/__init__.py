"""Architecture registry of the port, selectable via ``--arch <id>``.

Each ``src/repro_torch/configs/<id>.py`` module exports ``CONFIG`` (the
exact published dimensions, cited) and ``SMOKE`` (a reduced same-family
variant for the CPU tests).  Ported: the dense decoder (Llama) and the
Mamba-1 SSM (Falcon-Mamba), with the reference's dense configs (Yi-6B,
Phi-3-medium-14B, DeepSeek-Coder-33B and the paper's Sec. 5.5 model,
Llama-3-8B), and the Mixture-of-Experts decoders (Granite-3.0-MoE,
registered under the reference's id and as ``granite-moe-3b``, and
Snowflake Arctic), and the Mamba-2 hybrid with a shared attention block
(Zamba2-1.2B), and the non-text frontends: whisper-tiny's
encoder-decoder (an audio stub, cross attention) and Phi-3-vision's
vision prefix (a stub of patch embeddings).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama3.2-1b": "llama3p2_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-6b": "yi_6b",
    "phi3-medium-14b": "phi3_medium_14b",
    # paper Sec. 5.5 case-study model
    "llama3-8b": "llama3_8b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "granite-moe-3b": "granite_moe_3b",
    "arctic-480b": "arctic_480b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-tiny": "whisper_tiny",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
}

ARCH_IDS = list(_MODULES)
ALL_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
