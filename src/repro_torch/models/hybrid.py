"""Hybrid SSM + shared-attention models (Zamba2 family) and the pure-SSM LM
(Mamba2 family): the training loss and the serving path.  Counterpart of
src/repro/models/hybrid.py.

Zamba2 interleaves Mamba2 layers with a single SHARED transformer block
(attention + MLP) applied after every `hybrid_attn_every` layers; the shared
block's parameters are reused at every application, and its KV cache has one
entry per application site.  Layers past the last whole group form an
attention-free tail.

The layers are an `nn.ModuleList` run by a Python loop.  Decode state is
stacked over layers (conv [L,B,W-1,C], ssm [L,B,H,P,N]) and the shared
block's KV caches over sites ([sites,B,T,Hkv,D]); every call writes them in
place, so they keep their shapes and dtypes from step to step (the
reference returns new arrays, with the conv state in the activations'
dtype; the values are the same).  Under `remat` each Mamba2 layer is
recomputed in the backward pass (`transformer.remat_apply`); the shared
block is not, as in the reference.

Under tensor parallelism (DTensor params, `repro_torch.launch.sharding`)
the stacked states are DTensors placed by `decode_state_specs`, whose
layer dim is never split: each layer's state is read and written through
the stack's local tensor, so no DTensor op runs on a state per step.
Each block's output joins the residual stream in the dry run's
'residual' layout (`constrain`), as the dense family's do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from .attention import CAUSAL, Attention, attention_forward, init_attention
from .common import (ModelConfig, constrain, dense_init, resolve_device,
                     rms_norm)
from .mlp import MLP, init_mlp, mlp_forward
from .ssm import Mamba2, SSMState, init_mamba2, init_ssm_state, mamba2_forward
from .transformer import (_Applied, _norm, embed_tokens, lm_logits,
                          next_token_loss, remat_apply)

Caches = Tuple[torch.Tensor, torch.Tensor]


class SSMLayer(_Applied):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.ln = _norm(cfg.d_model, dtype, device)
        self.mamba = Mamba2(cfg, dtype, device)


class SSMLM(_Applied):
    """embed [V, d] (also the tied output projection), the Mamba2 layers and
    final_norm."""
    lm_head = None                            # the embeddings are tied

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=dtype, device=device))
        self.layers = nn.ModuleList(
            SSMLayer(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.final_norm = _norm(cfg.d_model, dtype, device)


class SharedBlock(nn.Module):
    """Zamba2's one shared attention + MLP block."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.ln_attn = _norm(cfg.d_model, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln_mlp = _norm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, cfg.mlp_variant)


class HybridLM(SSMLM):
    """SSMLM plus the shared block."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__(cfg, dtype, device)
        self.shared = SharedBlock(cfg, dtype, device)


@torch.no_grad()
def _init(cls, cfg: ModelConfig, generator: torch.Generator, dtype,
          device) -> SSMLM:
    """Random weights on `device` from `generator` (which lives there):
    built on the meta device first, so no memory is filled twice."""
    with torch.device("meta"):
        p = cls(cfg, dtype)
    p = p.to_empty(device=resolve_device(device))
    dense_init(p.embed, cfg.d_model, generator, scale=0.02)
    for layer in p.layers:
        layer.ln.zero_()
        init_mamba2(layer.mamba, generator)
    p.final_norm.zero_()
    if isinstance(p, HybridLM):
        init_attention(p.shared.attn, cfg, generator)
        init_mlp(p.shared.mlp, generator)
        p.shared.ln_attn.zero_()
        p.shared.ln_mlp.zero_()
    return p


# ---------------------------------------------------------------------- #
# pure SSM LM (mamba2)
# ---------------------------------------------------------------------- #

def init_ssm_lm(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> SSMLM:
    return _init(SSMLM, cfg, generator, dtype, device)


def _ssm_out(layer: SSMLayer, cfg: ModelConfig, h: torch.Tensor
             ) -> torch.Tensor:
    """One residual Mamba2 layer from a zero state (training)."""
    out, _ = mamba2_forward(layer.mamba, cfg,
                            rms_norm(h, layer.ln, cfg.norm_eps))
    return h + constrain(out, "residual")


def _layer_state(stack: torch.Tensor, i: int) -> torch.Tensor:
    """Layer i of a stacked state: a view; of a DTensor stack, a DTensor
    over its local tensor's layer i."""
    if not isinstance(stack, DTensor):
        return stack[i]
    return DTensor.from_local(stack.to_local()[i], stack.device_mesh, [
        Shard(p.dim - 1) if p.is_shard() else p for p in stack.placements],
        run_check=False)


def _write_layer(stack: torch.Tensor, i: int, new: torch.Tensor) -> None:
    """stack[i] = new in place (a DTensor through its local tensor: `new`
    has the layer's placements)."""
    if isinstance(stack, DTensor):
        stack.to_local()[i].copy_(new.to_local())
    else:
        stack[i].copy_(new)


def _ssm_layer(layer: SSMLayer, cfg: ModelConfig, h: torch.Tensor,
               states: Optional[SSMState], i: int,
               remat: bool = False) -> torch.Tensor:
    """One residual Mamba2 layer; writes layer i's new state into the
    stacked `states` in place when given.  remat: recompute the layer in
    the backward pass (training; no states)."""
    if states is None:
        return (remat_apply(layer, _ssm_out, cfg, h) if remat
                else _ssm_out(layer, cfg, h))
    if remat:
        raise ValueError("remat is for training, which runs without states")
    out, (conv, ssm) = mamba2_forward(
        layer.mamba, cfg, rms_norm(h, layer.ln, cfg.norm_eps),
        (_layer_state(states[0], i), _layer_state(states[1], i)))
    _write_layer(states[0], i, conv)
    _write_layer(states[1], i, ssm)
    return h + constrain(out, "residual")


def ssm_stack(params: SSMLM, cfg: ModelConfig, h: torch.Tensor,
              states: Optional[SSMState] = None, remat: bool = False
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """states: stacked (conv [L,B,W-1,C], ssm [L,B,H,P,N]) written in place,
    or None.  remat: recompute each layer in the backward pass."""
    for i, layer in enumerate(params.layers):
        h = constrain(_ssm_layer(layer, cfg, h, states, i, remat), "residual")
    return h, states


def ssm_lm_loss(params: SSMLM, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens [B,S] (+ optional loss_mask).  (loss, loss): no
    auxiliary term."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    h, _ = ssm_stack(params, cfg, h, remat=remat)
    loss = next_token_loss(params, cfg, h, tokens, batch.get("loss_mask"))
    return loss, loss


def init_ssm_lm_states(cfg: ModelConfig, batch: int, dtype=torch.float32,
                       device="cuda") -> SSMState:
    conv, ssm = init_ssm_state(cfg, batch, dtype, resolve_device(device))
    return (conv[None].repeat(cfg.num_layers, 1, 1, 1),
            ssm[None].repeat(cfg.num_layers, 1, 1, 1, 1))


def ssm_lm_decode_step(params: SSMLM, cfg: ModelConfig, token: torch.Tensor,
                       states: SSMState
                       ) -> Tuple[torch.Tensor, SSMState]:
    """O(1) decode: no positions, no cache index; the SSM state carries
    time."""
    h = embed_tokens(params, cfg, token)
    h, states = ssm_stack(params, cfg, h, states)
    return lm_logits(params, cfg, h), states


# ---------------------------------------------------------------------- #
# hybrid LM (zamba2)
# ---------------------------------------------------------------------- #

def num_shared_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


def init_hybrid_lm(cfg: ModelConfig, generator: torch.Generator,
                   dtype=torch.float32, device="cuda") -> HybridLM:
    return _init(HybridLM, cfg, generator, dtype, device)


def _shared_block(params: HybridLM, cfg: ModelConfig, h: torch.Tensor,
                  positions: Optional[torch.Tensor],
                  cache: Optional[Caches], cache_index: Optional[int]
                  ) -> torch.Tensor:
    """positions None: a prompt from position 0, which lets a CUDA call take
    the flash kernel.  The cache is written in place."""
    sp = params.shared
    a_out, _ = attention_forward(
        sp.attn, cfg, rms_norm(h, sp.ln_attn, cfg.norm_eps), positions,
        CAUSAL, cache=cache, cache_index=cache_index)
    h = h + constrain(a_out, "residual")
    m_in = rms_norm(h, sp.ln_mlp, cfg.norm_eps)
    return h + constrain(mlp_forward(sp.mlp, m_in, cfg.activation),
                         "residual")


def hybrid_stack(params: HybridLM, cfg: ModelConfig, h: torch.Tensor,
                 positions: Optional[torch.Tensor],
                 ssm_states: Optional[SSMState] = None,
                 kv_caches: Optional[Caches] = None,
                 cache_index: Optional[int] = None, remat: bool = False
                 ) -> Tuple[torch.Tensor, Optional[SSMState],
                            Optional[Caches]]:
    """Groups of `hybrid_attn_every` Mamba2 layers with the shared block
    after each group; the L mod every layers left over form an
    attention-free tail.  ssm_states: stacked over all L layers; kv_caches:
    (k, v) [sites,B,T,Hkv,D]; both written in place.  remat: recompute
    each Mamba2 layer in the backward pass (not the shared block, as in
    the reference)."""
    every = cfg.hybrid_attn_every
    for i, layer in enumerate(params.layers):
        h = constrain(_ssm_layer(layer, cfg, h, ssm_states, i, remat),
                      "residual")
        site = i // every
        if (i + 1) % every == 0 and site < num_shared_sites(cfg):
            kv = None if kv_caches is None else \
                (kv_caches[0][site], kv_caches[1][site])
            h = _shared_block(params, cfg, h, positions, kv, cache_index)
    return h, ssm_states, kv_caches


def hybrid_lm_loss(params: HybridLM, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens [B,S] (+ optional loss_mask).  (loss, loss).  Positions
    None: the sequence starts at 0."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    h, _, _ = hybrid_stack(params, cfg, h, None, remat=remat)
    loss = next_token_loss(params, cfg, h, tokens, batch.get("loss_mask"))
    return loss, loss


def init_hybrid_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.float32, device="cuda"
                       ) -> Tuple[SSMState, Caches]:
    device = resolve_device(device)
    kv_shape = (num_shared_sites(cfg), batch, max_len, cfg.num_kv_heads,
                cfg.hd)
    return (init_ssm_lm_states(cfg, batch, dtype, device),
            (torch.zeros(kv_shape, dtype=dtype, device=device),
             torch.zeros(kv_shape, dtype=dtype, device=device)))


def hybrid_decode_step(params: HybridLM, cfg: ModelConfig,
                       token: torch.Tensor, ssm_states: SSMState,
                       kv_caches: Caches, index: int
                       ) -> Tuple[torch.Tensor, SSMState, Caches]:
    h = embed_tokens(params, cfg, token)
    positions = torch.tensor([index], device=token.device)
    h, ssm_states, kv_caches = hybrid_stack(
        params, cfg, h, positions, ssm_states, kv_caches, index)
    return lm_logits(params, cfg, h), ssm_states, kv_caches
