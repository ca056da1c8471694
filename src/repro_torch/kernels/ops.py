"""Layout adapters between the models and the kernels."""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         spec, logit_cap: Optional[float]) -> torch.Tensor:
    """q: [B,S,H,D], k/v: [B,T,Hkv,D] -> [B,S,H,D]; the MaskSpec becomes the
    kernel's flags.  Query row i and kv row j are positions i and j: the
    caller guarantees that (see `repro_torch.models.attention.attend`).
    The kernel reads and writes the transposed views through their strides,
    so no copy is made."""
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=spec.causal, window=spec.window, prefix_len=spec.prefix_len,
        logit_cap=logit_cap)
    return out.transpose(1, 2)
