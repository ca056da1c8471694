"""Uniform Model interface; the port trains and serves the dense family.
Counterpart of src/repro/models/model_zoo.py.

    model = build_model(cfg, remat=True)
    params = model.init(seed, dtype, device)             # a DecoderLM
    loss, token_loss = model.loss(params, batch)         # train
    state = model.init_decode_state(batch, max_len, dtype, device)
    state, logits = model.prefill(params, batch, state)
    logits, state = model.decode_step(params, token, state, index)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import transformer
from .common import ModelConfig, resolve_device

# families of the reference that wait for later slices (ROADMAP.md queue A)
_NOT_PORTED = {
    "moe": "A4 (MoE)",
    "vlm": "A5 (other model families)",
    "audio": "A5 (other model families)",
    "hybrid": "A5 (other model families)",
    "ssm": "A5 (other model families)",
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    remat: bool = False          # per-layer activation recomputation

    def init(self, seed: int, dtype=torch.float32, device="cuda"
             ) -> transformer.DecoderLM:
        """Random weights from a generator seeded with `seed` on `device`."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return transformer.init_lm(self.cfg, gen, dtype, device)

    def loss(self, params: transformer.DecoderLM,
             batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total loss, token loss) of a batch with tokens [B, S]."""
        return transformer.lm_loss(params, self.cfg, batch, remat=self.remat)

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype=torch.float32, device="cuda"
                          ) -> Dict[str, Any]:
        return {"kv": transformer.init_kv_caches(
            self.cfg, batch_size, max_len, dtype, resolve_device(device))}

    def prefill(self, params: transformer.DecoderLM,
                batch: Dict[str, torch.Tensor], state: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        kv, logits = transformer.lm_prefill(
            params, self.cfg, batch["tokens"], state["kv"])
        return {"kv": kv}, logits

    def decode_step(self, params: transformer.DecoderLM,
                    token: torch.Tensor, state: Dict[str, Any], index: int
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, kv = transformer.lm_decode_step(
            params, self.cfg, token, state["kv"], index)
        return logits, {"kv": kv}


def build_model(cfg: ModelConfig, remat: bool = False) -> Model:
    if cfg.family == "dense" and cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: dense configs with experts are not ported yet "
            f"(ROADMAP.md queue A, item {_NOT_PORTED['moe']})")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md queue A, item {_NOT_PORTED[cfg.family]})")
    return Model(cfg, remat=remat)
