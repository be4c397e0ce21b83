"""Deterministic synthetic token batches (port of `repro.data.synthetic`).

A production run would stream tokenized shards; offline a reproducible
Zipf-ish token stream stands in, whose cursor is part of the checkpoint (a
resumed run replays the exact same batches).  The tokens come from numpy's
generator exactly as in the reference, so the same seed gives the same
tokens in both packages; they are returned as int64 CPU tensors (PyTorch's
index type).  `make_batch_for` ports all three branches: decoder-only,
vision (llava's precomputed patch embeddings) and enc-dec (whisper's stub
frame embeddings), the embeddings float32 and bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.config import ArchConfig


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


def make_batch_for(cfg: ArchConfig, seed: int, batch: int, seq: int) -> dict:
    """A batch shaped for `cfg`: (tokens, labels); for whisper the
    "frames" (batch, max_source_positions, d_model), the stub audio
    frontend's output, from a generator of their own seeded with `seed`;
    for llava the "patches" (batch, vision_tokens, vision_dim) with the
    text shortened to seq - vision_tokens (at least 8), so that the whole
    sequence is seq."""
    if cfg.is_encdec:
        out = lm_batch(seed, batch, seq, cfg.vocab)
        out["frames"] = torch.from_numpy(
            np.random.default_rng(seed).standard_normal(
                (batch, cfg.max_source_positions, cfg.d_model),
                dtype=np.float32))
        return out
    if cfg.vision_dim:
        out = lm_batch(seed, batch, max(seq - cfg.vision_tokens, 8),
                       cfg.vocab)
        out["patches"] = torch.from_numpy(
            np.random.default_rng(seed).standard_normal(
                (batch, cfg.vision_tokens, cfg.vision_dim),
                dtype=np.float32))
        return out
    return lm_batch(seed, batch, seq, cfg.vocab)


@dataclasses.dataclass
class TokenStream:
    """Checkpointable deterministic batch iterator: batch k of the stream is
    `make_batch_for(cfg, seed + k, batch, seq)`."""

    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    cursor: int = 0

    def next(self) -> dict:
        b = make_batch_for(self.cfg, self.seed + self.cursor, self.batch,
                           self.seq)
        self.cursor += 1
        return b

    def state_dict(self) -> dict:
        return {"seed": self.seed, "cursor": self.cursor}

    def load_state_dict(self, s: dict) -> None:
        self.seed, self.cursor = int(s["seed"]), int(s["cursor"])
