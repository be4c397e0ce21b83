"""Configurations of the port (counterpart of `repro.configs`).

`relexi_hit` holds the paper's HIT LES configurations.  The LM registry
below holds only the architectures whose path the port runs: `get(name)`
returns the full `ArchConfig`, `get_reduced(name)` the smoke-test scale of
the same family.
"""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

_MODULES = {
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


__all__ = ["ARCH_NAMES", "get", "get_reduced"]
