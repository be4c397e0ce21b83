"""Configurations of the port (counterpart of `repro.configs`).

`relexi_hit` holds the paper's HIT LES configurations.  The LM registry
below holds every architecture of the reference, in its order: the
decoder-only families and the enc-dec `whisper-tiny` (`models.encdec`).
`get(name)` returns the full `ArchConfig`, `get_reduced(name)` the
smoke-test scale of the same family.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig
from .shapes import SHAPES, ShapeConfig, cells, long_context_ok

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "starcoder2-7b": "starcoder2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "command-r-35b": "command_r_35b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-tiny": "whisper_tiny",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def all_configs() -> dict[str, ArchConfig]:
    return {n: get(n) for n in ARCH_NAMES}


__all__ = ["ARCH_NAMES", "SHAPES", "ShapeConfig", "cells", "long_context_ok",
           "get", "get_reduced", "all_configs"]
