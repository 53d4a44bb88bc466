"""Architecture registry (``repro.configs``), for the archs the port runs.

``get_arch(name)`` returns the full-size ArchConfig, ``get_smoke(name)``
the reduced same-family config the CPU tests use. ``ARCH_NAMES`` lists all
ten archs of the JAX package; the port runs seven (dense decoders with
global and sliding-window attention, MoE and xLSTM stacks), and the three
not yet ported (whisper-base, recurrentgemma-9b, paligemma-3b) raise
``NotImplementedError`` (ROADMAP.md §A3).
"""

from __future__ import annotations

from repro_torch.configs import (gemma3_12b, mixtral_8x22b, phi35_moe,
                                 phi4_mini, qwen15_32b, starcoder2_7b,
                                 xlstm_13b)
from repro_torch.models.config import ArchConfig

_MODULES = {
    "phi4-mini-3.8b": phi4_mini,
    "gemma3-12b": gemma3_12b,
    "qwen1.5-32b": qwen15_32b,
    "starcoder2-7b": starcoder2_7b,
    "mixtral-8x22b": mixtral_8x22b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "xlstm-1.3b": xlstm_13b,
}

ARCH_NAMES = (
    "whisper-base", "phi4-mini-3.8b", "gemma3-12b", "qwen1.5-32b",
    "starcoder2-7b", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b",
    "recurrentgemma-9b", "xlstm-1.3b", "paligemma-3b",
)


def _module(name: str):
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"{name}: not ported yet; the port runs {tuple(_MODULES)} "
            f"(ROADMAP.md §A3)")
    return _MODULES[name]


def get_arch(name: str) -> ArchConfig:
    cfg = _module(name).CONFIG
    cfg.validate()
    return cfg


def get_smoke(name: str) -> ArchConfig:
    cfg = _module(name).SMOKE
    cfg.validate()
    return cfg
