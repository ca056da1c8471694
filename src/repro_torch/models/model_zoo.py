"""Uniform Model interface; the port trains and serves the dense family and
serves the moe (qwen2-moe, mixtral), ssm (mamba2) and hybrid (zamba2)
families.
Counterpart of src/repro/models/model_zoo.py.

    model = build_model(cfg, remat=True)
    params = model.init(seed, dtype, device)     # DecoderLM, SSMLM or HybridLM
    loss, token_loss = model.loss(params, batch)         # train (dense)
    state = model.init_decode_state(batch, max_len, dtype, device)
    state, logits = model.prefill(params, batch, state)
    logits, state = model.decode_step(params, token, state, index)

Decode state is a dict: the KV caches for the dense and moe families, the
stacked conv and SSM states for ssm, both for hybrid.  The port writes it
in place.  The moe family (and a dense config with experts) takes the dense
family's path, its layers holding an MoE block in place of the MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from . import hybrid, transformer
from .common import ModelConfig, resolve_device

# what waits for later slices (ROADMAP.md queue A)
_NOT_PORTED = {
    "vlm": "A5 (other model families)",
    "audio": "A5 (other model families)",
}
_LOSS_NOT_PORTED = {"ssm": "A10", "hybrid": "A10"}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    remat: bool = False          # per-layer activation recomputation

    def init(self, seed: int, dtype=torch.float32, device="cuda"
             ) -> nn.Module:
        """Random weights from a generator seeded with `seed` on `device`."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        init = {"dense": transformer.init_lm, "moe": transformer.init_lm,
                "ssm": hybrid.init_ssm_lm,
                "hybrid": hybrid.init_hybrid_lm}[self.cfg.family]
        return init(self.cfg, gen, dtype, device)

    def loss(self, params: nn.Module, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total loss, token loss) of a batch with tokens [B, S]."""
        cfg = self.cfg
        # MoE training (the moe family and dense configs with experts) adds
        # 0.01 * the layers' aux loss: a later slice
        item = "A4b" if cfg.num_experts else _LOSS_NOT_PORTED.get(cfg.family)
        if item:
            raise NotImplementedError(
                f"{cfg.name}: training of family {cfg.family!r}"
                f"{' with experts' if cfg.num_experts else ''} is not ported "
                f"yet (ROADMAP.md queue A, item {item})")
        return transformer.lm_loss(params, self.cfg, batch, remat=self.remat)

    def init_decode_state(self, batch_size: int, max_len: int,
                          dtype=torch.float32, device="cuda"
                          ) -> Dict[str, Any]:
        cfg, device = self.cfg, resolve_device(device)
        if cfg.family == "hybrid":
            ssm, kv = hybrid.init_hybrid_caches(cfg, batch_size, max_len,
                                                dtype, device)
            return {"ssm": ssm, "kv": kv}
        if cfg.family == "ssm":
            return {"ssm": hybrid.init_ssm_lm_states(cfg, batch_size, dtype,
                                                     device)}
        return {"kv": transformer.init_kv_caches(cfg, batch_size, max_len,
                                                 dtype, device)}

    def prefill(self, params: nn.Module, batch: Dict[str, torch.Tensor],
                state: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """The prompt from position 0; returns (state, last-position
        logits [B,1,V])."""
        cfg, tokens = self.cfg, batch["tokens"]
        if cfg.family == "hybrid":
            h = transformer.embed_tokens(params, cfg, tokens)
            # positions None: 0..S-1, which lets the card take the flash
            # kernel (the reference passes arange(S))
            h, ssm, kv = hybrid.hybrid_stack(params, cfg, h, None,
                                             state["ssm"], state["kv"], 0)
            logits = transformer.lm_logits(params, cfg, h[:, -1:])
            return {"ssm": ssm, "kv": kv}, logits
        if cfg.family == "ssm":
            h = transformer.embed_tokens(params, cfg, tokens)
            h, ssm = hybrid.ssm_stack(params, cfg, h, state["ssm"])
            logits = transformer.lm_logits(params, cfg, h[:, -1:])
            return {"ssm": ssm}, logits
        kv, logits = transformer.lm_prefill(params, cfg, tokens, state["kv"])
        return {"kv": kv}, logits

    def decode_step(self, params: nn.Module, token: torch.Tensor,
                    state: Dict[str, Any], index: int
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        if cfg.family == "hybrid":
            logits, ssm, kv = hybrid.hybrid_decode_step(
                params, cfg, token, state["ssm"], state["kv"], index)
            return logits, {"ssm": ssm, "kv": kv}
        if cfg.family == "ssm":
            logits, ssm = hybrid.ssm_lm_decode_step(params, cfg, token,
                                                    state["ssm"])
            return logits, {"ssm": ssm}
        logits, kv = transformer.lm_decode_step(params, cfg, token,
                                                state["kv"], index)
        return logits, {"kv": kv}


def build_model(cfg: ModelConfig, remat: bool = False) -> Model:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md queue A, item {_NOT_PORTED[cfg.family]})")
    return Model(cfg, remat=remat)
