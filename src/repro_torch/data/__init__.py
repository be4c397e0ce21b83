"""Synthetic data of the port (counterpart of `repro.data`)."""
from .synthetic import TokenStream, lm_batch, make_batch_for

__all__ = ["TokenStream", "lm_batch", "make_batch_for"]
