"""Synthetic data of the port (counterpart of `repro.data`)."""
from .synthetic import lm_batch

__all__ = ["lm_batch"]
