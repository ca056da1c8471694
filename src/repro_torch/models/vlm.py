"""VLM backbone (PaliGemma-style).  Counterpart of src/repro/models/vlm.py.

The SigLIP vision tower is a stub, as in the reference: precomputed patch
embeddings [B, P, d] arrive as an input and are prepended to the text
embeddings; a gemma-style decoder (`transformer.DecoderLM`, which owns
every trainable weight) runs over both with a prefix-LM mask,
bidirectional over the P image rows and causal over the text.  Prefill
passes positions None (the sequence starts at the first patch), so on the
card its attention takes the flash kernel with `prefix_len = P`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import ModelConfig
from .transformer import (Caches, DecoderLM, decoder_stack, embed_tokens,
                          init_lm, lm_logits, next_token_loss)

init_vlm = init_lm


def _prefixed(params: DecoderLM, cfg: ModelConfig, patches: torch.Tensor,
              tokens: torch.Tensor) -> torch.Tensor:
    text = embed_tokens(params, cfg, tokens)
    return torch.cat([patches.to(text.dtype), text], dim=1)


def vlm_loss(params: DecoderLM, cfg: ModelConfig,
             batch: Dict[str, torch.Tensor], remat: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: patch_embed [B,P,d], tokens [B,S_text] (+ optional loss_mask).
    The token loss covers the text rows only; the total adds 0.01 * the
    MoE aux, as the reference does."""
    patches, tokens = batch["patch_embed"], batch["tokens"]
    p = patches.shape[1]
    h = _prefixed(params, cfg, patches, tokens)
    h, _, aux = decoder_stack(params, cfg, h, None, prefix_len=p,
                              remat=remat)
    loss = next_token_loss(params, cfg, h[:, p:], tokens,
                           batch.get("loss_mask"))
    return loss + 0.01 * aux, loss


def vlm_prefill(params: DecoderLM, cfg: ModelConfig, patches: torch.Tensor,
                tokens: torch.Tensor, caches: Caches
                ) -> Tuple[Caches, torch.Tensor]:
    """Patches then prompt into the caches from row 0; returns (caches,
    last-position logits [B,1,V])."""
    h = _prefixed(params, cfg, patches, tokens)
    h, caches, _ = decoder_stack(params, cfg, h, None, caches=caches,
                                 cache_index=0, prefix_len=patches.shape[1])
    return caches, lm_logits(params, cfg, h[:, -1:])


def vlm_decode_step(params: DecoderLM, cfg: ModelConfig, token: torch.Tensor,
                    caches: Caches, index: int
                    ) -> Tuple[torch.Tensor, Caches]:
    """index counts from 0 at the first image patch."""
    h = embed_tokens(params, cfg, token)
    h, caches, _ = decoder_stack(
        params, cfg, h, torch.tensor([index], device=token.device),
        caches=caches, cache_index=index, prefix_len=cfg.num_image_tokens)
    return lm_logits(params, cfg, h), caches
