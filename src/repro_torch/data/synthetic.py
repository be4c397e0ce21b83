"""Deterministic synthetic token batches (port of `repro.data.synthetic`'s
`_zipf_tokens` and `lm_batch`).

The tokens come from numpy's generator exactly as in the reference, so the
same seed gives the same tokens in both packages; they are returned as
int64 CPU tensors (PyTorch's index type).
"""
from __future__ import annotations

import numpy as np
import torch


def _zipf_tokens(rng: np.random.Generator, shape: tuple[int, ...], vocab: int
                 ) -> np.ndarray:
    """Zipf(1.2)-distributed token ids in [0, vocab), a crude natural-text
    frequency profile."""
    z = rng.zipf(1.2, size=shape).astype(np.int64)
    return z % vocab


def lm_batch(seed: int, batch: int, seq: int, vocab: int) -> dict:
    """One (tokens, labels) next-token batch, each (batch, seq)."""
    stream = torch.from_numpy(_zipf_tokens(np.random.default_rng(seed),
                                           (batch, seq + 1), vocab))
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
