"""Decoder-only transformer LM, dense family: the serving path.  Counterpart
of src/repro/models/transformer.py.

The layers are an `nn.ModuleList` run by a Python loop; gemma2's period-2
local/global pattern picks each layer's MaskSpec by its index.  KV caches are
stacked [L, B, T, Hkv, D] tensors that attention writes in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .attention import (Attention, MaskSpec, attention_forward,
                        init_attention, ring_positions)
from .common import ModelConfig, dense_init, rms_norm, softcap
from .mlp import MLP, init_mlp, mlp_forward

Caches = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------- #
# layer
# ---------------------------------------------------------------------- #

def _norm(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln_attn = _norm(d, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln_mlp = _norm(d, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, dtype, device, cfg.mlp_variant)
        if cfg.sandwich_norm:
            self.ln_attn_post = _norm(d, dtype, device)
            self.ln_mlp_post = _norm(d, dtype, device)


@torch.no_grad()
def init_decoder_layer(p: DecoderLayer, cfg: ModelConfig,
                       generator: torch.Generator) -> None:
    init_attention(p.attn, cfg, generator)
    init_mlp(p.mlp, generator)
    for w in p.parameters(recurse=False):   # the norms
        w.zero_()


def decoder_layer(p: DecoderLayer, cfg: ModelConfig, h: torch.Tensor,
                  positions: Optional[torch.Tensor], spec: MaskSpec,
                  cache: Optional[Caches] = None,
                  cache_index: Optional[int] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Caches]]:
    """Returns (h, new_cache)."""
    attn_in = rms_norm(h, p.ln_attn, cfg.norm_eps)
    attn_out, new_cache = attention_forward(
        p.attn, cfg, attn_in, positions, spec,
        cache=cache, cache_index=cache_index,
        cache_positions=cache_positions,
        logit_cap=cfg.attn_logit_softcap)
    if cfg.sandwich_norm:
        attn_out = rms_norm(attn_out, p.ln_attn_post, cfg.norm_eps)
    h = h + attn_out
    mlp_in = rms_norm(h, p.ln_mlp, cfg.norm_eps)
    mlp_out = mlp_forward(p.mlp, mlp_in, cfg.activation)
    if cfg.sandwich_norm:
        mlp_out = rms_norm(mlp_out, p.ln_mlp_post, cfg.norm_eps)
    return h + mlp_out, new_cache


# ---------------------------------------------------------------------- #
# full model
# ---------------------------------------------------------------------- #

def layer_specs(cfg: ModelConfig) -> Tuple[MaskSpec, ...]:
    """Per-position-in-pattern mask specs.  Period 2 for gemma2's
    local/global alternation, else period 1."""
    if cfg.local_global_pattern:
        if not cfg.sliding_window:
            raise ValueError("local/global pattern needs a window")
        return (MaskSpec(causal=True, window=cfg.sliding_window),
                MaskSpec(causal=True))
    return (MaskSpec(causal=True, window=cfg.sliding_window),)


class DecoderLM(nn.Module):
    """embed [V, d] (also the output projection when tied), the layers,
    final_norm, and lm_head as an `nn.Linear` when untied."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=dtype, device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.final_norm = _norm(cfg.d_model, dtype, device)
        self.lm_head = None if cfg.tie_embeddings else nn.Linear(
            cfg.d_model, cfg.vocab_size, bias=False, dtype=dtype,
            device=device)


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator,
            dtype=torch.float32, device="cpu") -> DecoderLM:
    """Random weights drawn on `device` from `generator` (which must live on
    that device): normal * 1/sqrt(fan_in), embedding scale 0.02, norms 0.
    The module is built on the meta device first, so no memory is filled
    twice."""
    with torch.device("meta"):
        p = DecoderLM(cfg, dtype)
    p = p.to_empty(device=device)
    dense_init(p.embed, cfg.d_model, generator, scale=0.02)
    for layer in p.layers:
        init_decoder_layer(layer, cfg, generator)
    p.final_norm.zero_()
    if p.lm_head is not None:
        dense_init(p.lm_head.weight, cfg.d_model, generator)
    return p


def decoder_stack(params: DecoderLM, cfg: ModelConfig, h: torch.Tensor,
                  positions: Optional[torch.Tensor],
                  caches: Optional[Caches] = None,
                  cache_index: Optional[int] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  prefix_len: int = 0,
                  ) -> Tuple[torch.Tensor, Optional[Caches]]:
    """Run the layer stack.  caches: stacked (k, v) [L, B, T, Hkv, D],
    written in place."""
    specs = layer_specs(cfg)
    if prefix_len:
        specs = tuple(
            MaskSpec(causal=s.causal, window=s.window, prefix_len=prefix_len)
            for s in specs)
    for i, layer in enumerate(params.layers):
        cache = None if caches is None else (caches[0][i], caches[1][i])
        h, _ = decoder_layer(layer, cfg, h, positions, specs[i % len(specs)],
                             cache, cache_index, cache_positions)
    return h, caches


def embed_tokens(params: DecoderLM, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    h = params.embed[tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(h.dtype)
    return h


def lm_logits(params: DecoderLM, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    """fp32 logits, with the final softcap."""
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    if params.lm_head is None:
        logits = h @ params.embed.T
    else:
        logits = params.lm_head(h)
    return softcap(logits.float(), cfg.final_logit_softcap)


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #

def kv_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Sliding-window archs (uniform window, e.g. mixtral) only ever need
    `window` rows -- the ring buffer bounds decode memory at long context."""
    if cfg.sliding_window and not cfg.local_global_pattern:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.float32, device="cpu") -> Caches:
    clen = kv_cache_len(cfg, max_len)
    shape = (cfg.num_layers, batch, clen, cfg.num_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def lm_prefill(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
               caches: Caches, prefix_len: int = 0
               ) -> Tuple[Caches, torch.Tensor]:
    """Run the prompt through the stack, filling the caches from index 0.
    Returns (caches, last-position logits).  The prompt's positions are
    0..S-1 by construction, so on CUDA its attention takes the flash
    kernel."""
    h = embed_tokens(params, cfg, tokens)
    h, caches = decoder_stack(params, cfg, h, None, caches=caches,
                              cache_index=0, prefix_len=prefix_len)
    return caches, lm_logits(params, cfg, h[:, -1:])


def lm_decode_step(params: DecoderLM, cfg: ModelConfig, token: torch.Tensor,
                   caches: Caches, index: int
                   ) -> Tuple[torch.Tensor, Caches]:
    """One-token decode.  token: [B,1]; index: absolute position.
    Ring-buffer caches (len < max positions, e.g. sliding-window archs) wrap
    the write index; row positions mask wrapped/garbage rows.
    Returns (logits [B,1,V], caches)."""
    h = embed_tokens(params, cfg, token)
    positions = torch.tensor([index], device=token.device)
    clen = caches[0].shape[2]
    h, caches = decoder_stack(
        params, cfg, h, positions, caches=caches, cache_index=index % clen,
        cache_positions=ring_positions(index, clen, token.device))
    return lm_logits(params, cfg, h), caches
