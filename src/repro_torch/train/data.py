"""Deterministic synthetic batches.  Counterpart of src/repro/train/data.py:
each token row of the global batch is drawn from its own numpy generator
seeded with (seed, step, row), so any slice of the global batch is the same
whoever loads it, and the tokens equal the reference's.

The vlm and audio families also get their stub frontends' outputs, as in
the reference: `patch_embed` [rows, num_image_tokens, d] and `audio_embed`
[rows, encoder_seq, d], standard normal times 0.02 in float32, each drawn
in one piece for the slice from a generator seeded with (seed, step,
key(name)).  The reference's key is `hash(name) & 0x7FFFFFFF`, which
Python salts per process; here the default key is `zlib.crc32`, the same in
every process, so data-parallel ranks (fresh processes) and a restarted
run see one stream.  `stream_key` takes another key function (a test
passes the reference's to compare the draws).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # frontend stubs (vlm / audio)
    num_image_tokens: int = 0
    encoder_seq: int = 0
    d_model: int = 0


def stream_key(name: str) -> int:
    return zlib.crc32(name.encode())


def host_batch_slice(cfg: DataConfig, step: int, lo: int, hi: int,
                     key: Callable[[str], int] = stream_key
                     ) -> Dict[str, torch.Tensor]:
    """Rows [lo, hi) of the global batch for `step`, on the CPU: tokens
    [hi - lo, S] int64, and the frontend embeddings the config asks for."""
    rows = [np.random.default_rng(np.random.SeedSequence([cfg.seed, step, r]))
            .integers(0, cfg.vocab_size, cfg.seq_len, dtype=np.int32)
            for r in range(lo, hi)]
    tokens = np.stack(rows) if rows else np.zeros((0, cfg.seq_len), np.int32)
    out = {"tokens": torch.from_numpy(tokens).long()}
    for name, field, width in (("patch", "patch_embed", cfg.num_image_tokens),
                               ("audio", "audio_embed", cfg.encoder_seq)):
        if width:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, key(name)]))
            out[field] = torch.from_numpy(rng.standard_normal(
                (hi - lo, width, cfg.d_model), dtype=np.float32) * 0.02)
    return out
