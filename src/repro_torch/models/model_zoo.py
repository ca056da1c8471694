"""Uniform Model interface over all six families: dense, moe, vlm
(paligemma), audio (whisper), ssm (mamba2) and hybrid (zamba2); each
builds, trains and serves.  Counterpart of src/repro/models/model_zoo.py.

    model = build_model(cfg, remat=True)
    params = model.init(seed, dtype, device)  # DecoderLM, SSMLM, HybridLM
    loss, token_loss = model.loss(params, batch)         # or EncDecLM
    state = model.init_decode_state(batch, max_len, dtype, device)
    state, logits = model.prefill(params, batch, state)
    logits, state = model.decode_step(params, token, state, index)

A batch holds tokens [B, S], plus patch_embed [B, P, d] for vlm and
audio_embed [B, T_enc, d] for audio (the stub frontends' outputs).  The
total loss adds 0.01 * the MoE aux where a config has experts.  Decode
state is a dict: the KV caches for the dense, moe and vlm families (a vlm
decode index counts from the first patch), plus the encoder output
`enc_out` [B, T_enc, d] for audio, the stacked conv and SSM states for ssm,
both for hybrid.  The port writes caches and states in place.  The moe
family (and a dense config with experts) takes the dense family's path,
its layers holding an MoE block in place of the MLP.

Params whose leaves are DTensors (tensor parallelism, placed by
repro_torch.launch.sharding) run through the same functions: each entry
point then treats plain tensors (tokens, positions, masks, frontend
embeddings) as replicated over the mesh (`implicit_replication`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Iterator, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from . import encdec, hybrid, transformer, vlm
from .common import (ModelConfig, draw_normal, recorded_draws,
                     resolve_device)


def _mixes_dtensors(fn):
    """Run `fn(self, params, ...)` with plain tensors taken as replicated
    when the params are DTensors."""
    @functools.wraps(fn)
    def run(self, params, *args, **kwargs):
        sharded = any(isinstance(p, DTensor) for p in params.parameters())
        with implicit_replication() if sharded else contextlib.nullcontext():
            return fn(self, params, *args, **kwargs)
    return run


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    remat: bool = False          # per-layer activation recomputation

    def _init_fn(self):
        return {"dense": transformer.init_lm, "moe": transformer.init_lm,
                "vlm": vlm.init_vlm, "audio": encdec.init_encdec,
                "ssm": hybrid.init_ssm_lm,
                "hybrid": hybrid.init_hybrid_lm}[self.cfg.family]

    def init(self, seed: int, dtype=torch.float32, device="cuda"
             ) -> nn.Module:
        """Random weights from a generator seeded with `seed` on `device`."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return self._init_fn()(self.cfg, gen, dtype, device)

    def init_leaves(self, seed: int, dtype=torch.float32, device="cuda",
                    draw: bool = True
                    ) -> Tuple[nn.Module, Iterator[Tuple[str, torch.Tensor]]]:
        """`init(seed, dtype, device)` one parameter at a time: (the module
        on the meta device, an iterator of (name, whole tensor on
        `device`)) in the order `init` draws or fills them, then the
        parameters it zeroes.  With draw=False the drawn tensors are left
        empty (a rank that receives the weights from another).  Only one
        whole parameter need be held at a time, so a model larger than one
        card can be placed as it is made."""
        device = resolve_device(device)
        with recorded_draws() as draws:
            meta = self._init_fn()(self.cfg, None, dtype, "meta")
        names = {id(p): n for n, p in meta.named_parameters()}
        made = [(names[id(w)], scale, value) for w, scale, value in draws]

        def leaves():
            gen = torch.Generator(device=device).manual_seed(seed) \
                if draw else None
            shapes = dict((n, p.shape) for n, p in meta.named_parameters())
            for name, scale, value in made:
                if scale is None:
                    yield name, torch.full(shapes[name], value, dtype=dtype,
                                           device=device)
                else:
                    yield name, (draw_normal(shapes[name], scale, gen,
                                             device).to(dtype) if draw
                                 else torch.empty(shapes[name], dtype=dtype,
                                                  device=device))
            seen = {n for n, _, _ in made}
            for name, shape in shapes.items():
                if name not in seen:
                    yield name, torch.zeros(shape, dtype=dtype,
                                            device=device)
        return meta, leaves()

    @_mixes_dtensors
    def loss(self, params: nn.Module, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total loss, token loss) of a batch with tokens [B, S] (and the
        family's frontend embeddings)."""
        loss = {"dense": transformer.lm_loss, "moe": transformer.lm_loss,
                "vlm": vlm.vlm_loss, "audio": encdec.encdec_loss,
                "ssm": hybrid.ssm_lm_loss,
                "hybrid": hybrid.hybrid_lm_loss}[self.cfg.family]
        return loss(params, self.cfg, batch, remat=self.remat)

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
        kv = transformer.init_kv_caches(cfg, batch_size, max_len, dtype,
                                        device)
        if cfg.family == "audio":
            return {"kv": kv, "enc_out": torch.zeros(
                (batch_size, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                device=device)}
        return {"kv": kv}

    @_mixes_dtensors
    def prefill(self, params: nn.Module, batch: Dict[str, torch.Tensor],
                state: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """The prompt from position 0 (for vlm, the patches and then the
        prompt); returns (state, last-position logits [B,1,V])."""
        cfg, tokens = self.cfg, batch["tokens"]
        if cfg.family == "vlm":
            kv, logits = vlm.vlm_prefill(params, cfg, batch["patch_embed"],
                                         tokens, state["kv"])
            return {"kv": kv}, logits
        if cfg.family == "audio":
            kv, enc_out, logits = encdec.encdec_prefill(
                params, cfg, batch["audio_embed"], tokens, state["kv"])
            return {"kv": kv, "enc_out": enc_out}, logits
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

    @_mixes_dtensors
    def decode_step(self, params: nn.Module, token: torch.Tensor,
                    state: Dict[str, Any], index: int
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        if cfg.family == "vlm":
            logits, kv = vlm.vlm_decode_step(params, cfg, token, state["kv"],
                                             index)
            return logits, {"kv": kv}
        if cfg.family == "audio":
            logits, kv = encdec.encdec_decode_step(
                params, cfg, token, state["enc_out"], state["kv"], index)
            return logits, {"kv": kv, "enc_out": state["enc_out"]}
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
    return Model(cfg, remat=remat)
