"""Architecture registry: the 10 architectures of src/repro/configs, with the
same values, their shape grid (40 cells) and the documented long_500k
skips, and the tiny same-family configs the tests use."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.models.common import ModelConfig

from .shapes import ALL_SHAPES, ShapeSpec
from .mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from .gemma2_2b import CONFIG as GEMMA2_2B
from .command_r_35b import CONFIG as COMMAND_R_35B
from .qwen3_8b import CONFIG as QWEN3_8B
from .qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from .mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from .paligemma_3b import CONFIG as PALIGEMMA_3B
from .whisper_medium import CONFIG as WHISPER_MEDIUM
from .zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from .mamba2_780m import CONFIG as MAMBA2_780M

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        MISTRAL_NEMO_12B, GEMMA2_2B, COMMAND_R_35B, QWEN3_8B,
        QWEN2_MOE_A2_7B, MIXTRAL_8X7B, PALIGEMMA_3B, WHISPER_MEDIUM,
        ZAMBA2_1_2B, MAMBA2_780M)
}

# archs whose decode state stays bounded (or O(1)) at 500k context
_LONG_CONTEXT_OK = {"mixtral-8x7b", "zamba2-1.2b", "mamba2-780m"}

_SKIP_REASONS = {
    "mistral-nemo-12b": "pure full attention: unbounded 500k KV per layer",
    "command-r-35b": "pure full attention: unbounded 500k KV per layer",
    "qwen3-8b": "pure full attention: unbounded 500k KV per layer",
    "qwen2-moe-a2.7b": "pure full attention: unbounded 500k KV per layer",
    "paligemma-3b": "full-attention prefix LM: unbounded 500k KV",
    "gemma2-2b": "alternating global layers are full attention at 500k",
    "whisper-medium": "decoder hard-capped at 448 positions by design",
}


def skip_reason(arch: str, shape: ShapeSpec) -> Optional[str]:
    """None = the (arch, shape) cell runs; else the documented skip."""
    if shape.name == "long_500k" and arch not in _LONG_CONTEXT_OK:
        return _SKIP_REASONS[arch]
    return None


def cells() -> List[Tuple[ModelConfig, ShapeSpec, Optional[str]]]:
    """The full 40-cell grid with skip annotations."""
    out = []
    for cfg in ARCHS.values():
        for shape in ALL_SHAPES:
            out.append((cfg, shape, skip_reason(cfg.name, shape)))
    return out


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = get_config(name)
    small = dict(
        num_layers=max(2, (2 if not base.hybrid_attn_every else 4)),
        d_model=64, d_ff=128, vocab_size=256, max_seq_len=512,
        head_dim=16,
    )
    if base.num_heads:
        small["num_heads"] = 4
        small["num_kv_heads"] = min(base.num_kv_heads, 2) or 1
        if base.num_kv_heads == base.num_heads:
            small["num_kv_heads"] = 4
    if base.num_experts:
        small.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
                     num_shared_experts=min(base.num_shared_experts, 1))
    if base.ssm_state_dim:
        small.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=16)
    if base.hybrid_attn_every:
        small.update(hybrid_attn_every=2, num_layers=4)
    if base.is_encoder_decoder:
        small.update(encoder_layers=2, encoder_seq=64)
    if base.num_image_tokens:
        small.update(num_image_tokens=16)
    if base.sliding_window:
        small.update(sliding_window=64)
    small.update(overrides)
    return dataclasses.replace(base, **small)
