"""Encoder-decoder transformer (Whisper-style).  Counterpart of
src/repro/models/encdec.py.

The audio conv frontend is a stub, as in the reference: precomputed frame
embeddings [B, T_enc, d] arrive as an input.  The encoder is a
bidirectional self-attention stack over them plus sinusoidal positions;
the decoder layer is causal self-attention, cross-attention to the
encoder's output and a plain (non-gated) GELU MLP.  Both stacks apply rope
in their self-attention, as the reference does.  Cross-attention's k and v
are projected from the encoder output in every call, decode steps included
(the reference's semantics).

Prompt processing passes positions None wherever they are 0..S-1 by
construction, so on the card the encoder (non-causal, T_enc x T_enc), the
decoder's self-attention (causal) and its cross-attention (non-causal,
S x T_enc) all take the flash kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .attention import (CAUSAL, FULL, Attention, attention_forward,
                        init_attention, split_heads)
from .common import (ModelConfig, constrain, dense_init, linear,
                     resolve_device, rms_norm)
from .mlp import MLP, init_mlp, mlp_forward
from .transformer import (Caches, _Applied, _norm, embed_tokens, lm_logits,
                          next_token_loss, remat_apply)


def sinusoid_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    table = np.zeros((length, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


class EncoderLayer(_Applied):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln_attn = _norm(d, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln_mlp = _norm(d, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, dtype, device, cfg.mlp_variant)


class DecoderLayerXAttn(_Applied):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln_self = _norm(d, dtype, device)
        self.self_attn = Attention(cfg, dtype, device)
        self.ln_cross = _norm(d, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device)
        self.ln_mlp = _norm(d, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, dtype, device, cfg.mlp_variant)


class EncDecLM(_Applied):
    """embed [V, d] (also the tied output projection), the encoder layers,
    enc_norm, the decoder layers and final_norm."""
    lm_head = None                            # the embeddings are tied

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=dtype, device=device))
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, dtype, device)
            for _ in range(cfg.encoder_layers))
        self.enc_norm = _norm(cfg.d_model, dtype, device)
        self.dec_layers = nn.ModuleList(
            DecoderLayerXAttn(cfg, dtype, device)
            for _ in range(cfg.num_layers))
        self.final_norm = _norm(cfg.d_model, dtype, device)


@torch.no_grad()
def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> EncDecLM:
    """Random weights on `device` from `generator` (which lives there):
    normal * 1/sqrt(fan_in), embedding scale 0.02, norms 0; built on the
    meta device first, so no memory is filled twice."""
    with torch.device("meta"):
        p = EncDecLM(cfg, dtype)
    p = p.to_empty(device=resolve_device(device))
    dense_init(p.embed, cfg.d_model, generator, scale=0.02)
    for layer in p.enc_layers:
        init_attention(layer.attn, cfg, generator)
        init_mlp(layer.mlp, generator)
    for layer in p.dec_layers:
        init_attention(layer.self_attn, cfg, generator)
        init_attention(layer.cross_attn, cfg, generator)
        init_mlp(layer.mlp, generator)
    for layer in (*p.enc_layers, *p.dec_layers):
        for w in layer.parameters(recurse=False):   # the norms
            w.zero_()
    p.enc_norm.zero_()
    p.final_norm.zero_()
    return p


# ---------------------------------------------------------------------- #
# encoder
# ---------------------------------------------------------------------- #

def _encoder_layer(lp: EncoderLayer, cfg: ModelConfig, h: torch.Tensor
                   ) -> torch.Tensor:
    a_out, _ = attention_forward(
        lp.attn, cfg, rms_norm(h, lp.ln_attn, cfg.norm_eps), None, FULL)
    h = h + constrain(a_out, "residual")
    m_in = rms_norm(h, lp.ln_mlp, cfg.norm_eps)
    return h + constrain(mlp_forward(lp.mlp, m_in, cfg.activation),
                         "residual")


def encode(params: EncDecLM, cfg: ModelConfig, audio_embed: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """audio_embed: [B, T_enc, d] (the stub frontend's output) ->
    enc_out [B, T_enc, d]."""
    t = audio_embed.shape[1]
    table = torch.from_numpy(sinusoid_positions(t, cfg.d_model)).to(
        device=audio_embed.device, dtype=audio_embed.dtype)
    h = audio_embed + table[None]
    for lp in params.enc_layers:
        h = constrain(remat_apply(lp, _encoder_layer, cfg, h) if remat
                      else _encoder_layer(lp, cfg, h), "residual")
    return rms_norm(h, params.enc_norm, cfg.norm_eps)


# ---------------------------------------------------------------------- #
# decoder
# ---------------------------------------------------------------------- #

def _cross_kv(lp: DecoderLayerXAttn, cfg: ModelConfig, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's cross-attention k, v [B, T_enc, Hkv, D]: views of
    contiguous projections, so their rows keep the flash kernel's
    alignment."""
    k = split_heads(linear(lp.cross_attn.wk, enc_out), cfg.num_kv_heads,
                    cfg.hd)
    v = split_heads(linear(lp.cross_attn.wv, enc_out), cfg.num_kv_heads,
                    cfg.hd)
    return k, v


def _decoder_layer(lp: DecoderLayerXAttn, cfg: ModelConfig, h: torch.Tensor,
                   enc_out: torch.Tensor, positions: Optional[torch.Tensor],
                   cache: Optional[Caches] = None,
                   cache_index: Optional[int] = None) -> torch.Tensor:
    """Self-attention (writing `cache` in place when given), cross-attention
    to enc_out, MLP."""
    s_out, _ = attention_forward(
        lp.self_attn, cfg, rms_norm(h, lp.ln_self, cfg.norm_eps), positions,
        CAUSAL, cache=cache, cache_index=cache_index)
    h = h + constrain(s_out, "residual")
    c_out, _ = attention_forward(
        lp.cross_attn, cfg, rms_norm(h, lp.ln_cross, cfg.norm_eps),
        positions, FULL, kv_override=_cross_kv(lp, cfg, enc_out))
    h = h + constrain(c_out, "residual")
    m_in = rms_norm(h, lp.ln_mlp, cfg.norm_eps)
    return h + constrain(mlp_forward(lp.mlp, m_in, cfg.activation),
                         "residual")


def decode_stack(params: EncDecLM, cfg: ModelConfig, h: torch.Tensor,
                 positions: Optional[torch.Tensor], enc_out: torch.Tensor,
                 caches: Optional[Caches] = None,
                 cache_index: Optional[int] = None, remat: bool = False
                 ) -> Tuple[torch.Tensor, Optional[Caches]]:
    """positions: [S], or None for 0..S-1.  caches: stacked (k, v)
    [L, B, T, Hkv, D] of the self-attention, written in place.  remat:
    recompute each layer in backward (training; no caches)."""
    if remat and caches is not None:
        raise ValueError("remat is for training, which runs without caches")
    for i, lp in enumerate(params.dec_layers):
        if remat:
            h = remat_apply(lp, _decoder_layer, cfg, h, enc_out, positions)
        else:
            cache = None if caches is None else (caches[0][i], caches[1][i])
            h = _decoder_layer(lp, cfg, h, enc_out, positions, cache,
                               cache_index)
        h = constrain(h, "residual")
    return h, caches


def encdec_loss(params: EncDecLM, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: audio_embed [B,T_enc,d], tokens [B,S_dec] (+ optional
    loss_mask).  (loss, loss): no auxiliary term."""
    enc_out = encode(params, cfg, batch["audio_embed"], remat=remat)
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    h, _ = decode_stack(params, cfg, h, None, enc_out, remat=remat)
    loss = next_token_loss(params, cfg, h, tokens, batch.get("loss_mask"))
    return loss, loss


def encdec_prefill(params: EncDecLM, cfg: ModelConfig,
                   audio_embed: torch.Tensor, tokens: torch.Tensor,
                   caches: Caches
                   ) -> Tuple[Caches, torch.Tensor, torch.Tensor]:
    """Returns (caches, enc_out, last-position logits [B,1,V])."""
    enc_out = encode(params, cfg, audio_embed)
    h = embed_tokens(params, cfg, tokens)
    h, caches = decode_stack(params, cfg, h, None, enc_out, caches=caches,
                             cache_index=0)
    return caches, enc_out, lm_logits(params, cfg, h[:, -1:])


def encdec_decode_step(params: EncDecLM, cfg: ModelConfig,
                       token: torch.Tensor, enc_out: torch.Tensor,
                       caches: Caches, index: int
                       ) -> Tuple[torch.Tensor, Caches]:
    h = embed_tokens(params, cfg, token)
    h, caches = decode_stack(
        params, cfg, h, torch.tensor([index], device=token.device), enc_out,
        caches=caches, cache_index=index)
    return lm_logits(params, cfg, h), caches
