"""Deterministic synthetic token batches.  Counterpart of the token stream of
src/repro/train/data.py: each row of the global batch is drawn from its own
numpy generator seeded with (seed, step, row), so any slice of the global
batch is the same whoever loads it, and the tokens equal the reference's.
The patch and audio streams of the vlm and audio families wait for those
families (ROADMAP.md queue A, item A5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def host_batch_slice(cfg: DataConfig, step: int, lo: int, hi: int
                     ) -> Dict[str, torch.Tensor]:
    """Rows [lo, hi) of the global batch for `step`: tokens [hi - lo, S]
    int64 on the CPU."""
    rows = [np.random.default_rng(np.random.SeedSequence([cfg.seed, step, r]))
            .integers(0, cfg.vocab_size, cfg.seq_len, dtype=np.int32)
            for r in range(lo, hi)]
    tokens = np.stack(rows) if rows else np.zeros((0, cfg.seq_len), np.int32)
    return {"tokens": torch.from_numpy(tokens).long()}
