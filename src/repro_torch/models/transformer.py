"""Decoder-only transformer LM, dense family: the training loss and the
serving path.  Counterpart of src/repro/models/transformer.py.

The layers are an `nn.ModuleList` run by a Python loop; gemma2's period-2
local/global pattern picks each layer's MaskSpec by its index.  KV caches are
stacked [L, B, T, Hkv, D] tensors that attention writes in place.

`DecoderLM` and `DecoderLayer` have a generic `forward(fn, *args)` that
returns `fn(module, *args)`, so `torch.func.functional_call` can run any of
the functions here on swapped-in weights (the trainer's bf16 compute copy of
fp32 masters).  Per-layer recomputation (`remat=True`) passes each layer's
weights to `torch.utils.checkpoint` as inputs and swaps them in again for
the recomputation, which runs after the outer swap has ended.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch import obs

from .attention import (Attention, MaskSpec, _placed, attention_forward,
                        init_attention, ring_positions)
from .common import (ModelConfig, constrain, dense_init, resolve_device,
                     rms_norm, softcap, unshard, unsplit_sequence)
from .mlp import MLP, init_mlp, mlp_forward
from .moe import MoE, init_moe, moe_forward

Caches = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------- #
# layer
# ---------------------------------------------------------------------- #

def _norm(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class _Applied(nn.Module):
    def forward(self, fn, *args):
        """fn(self, *args): under `torch.func.functional_call`, fn sees the
        swapped-in weights."""
        return fn(self, *args)


class DecoderLayer(_Applied):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln_attn = _norm(d, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ln_mlp = _norm(d, dtype, device)
        if cfg.num_experts:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(d, cfg.d_ff, dtype, device, cfg.mlp_variant)
        if cfg.sandwich_norm:
            self.ln_attn_post = _norm(d, dtype, device)
            self.ln_mlp_post = _norm(d, dtype, device)


@torch.no_grad()
def init_decoder_layer(p: DecoderLayer, cfg: ModelConfig,
                       generator: torch.Generator) -> None:
    init_attention(p.attn, cfg, generator)
    if cfg.num_experts:
        init_moe(p.moe, cfg, generator)
    else:
        init_mlp(p.mlp, generator)
    for w in p.parameters(recurse=False):   # the norms
        w.zero_()


def decoder_layer(p: DecoderLayer, cfg: ModelConfig, h: torch.Tensor,
                  positions: Optional[torch.Tensor], spec: MaskSpec,
                  cache: Optional[Caches] = None,
                  cache_index: Optional[int] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Caches], Any]:
    """Returns (h, new_cache, moe_aux): the aux is the MoE layer's float32
    load-balancing loss, 0.0 for a dense layer."""
    attn_in = rms_norm(h, p.ln_attn, cfg.norm_eps)
    attn_out, new_cache = attention_forward(
        p.attn, cfg, attn_in, positions, spec,
        cache=cache, cache_index=cache_index,
        cache_positions=cache_positions,
        logit_cap=cfg.attn_logit_softcap)
    if cfg.sandwich_norm:
        attn_out = rms_norm(attn_out, p.ln_attn_post, cfg.norm_eps)
    h = h + constrain(attn_out, "residual")
    mlp_in = rms_norm(h, p.ln_mlp, cfg.norm_eps)
    aux = 0.0
    if cfg.num_experts:
        mlp_out, aux = moe_forward(p.moe, cfg, mlp_in)
    else:
        mlp_out = mlp_forward(p.mlp, mlp_in, cfg.activation)
    if cfg.sandwich_norm:
        mlp_out = rms_norm(mlp_out, p.ln_mlp_post, cfg.norm_eps)
    return h + constrain(mlp_out, "residual"), new_cache, aux


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


class DecoderLM(_Applied):
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
            dtype=torch.float32, device="cuda") -> DecoderLM:
    """Random weights drawn on `device` (the card unless the caller asks for
    the CPU) from `generator`, which must live on that device: normal *
    1/sqrt(fan_in), embedding scale 0.02, norms 0.  The module is built on
    the meta device first, so no memory is filled twice."""
    with torch.device("meta"):
        p = DecoderLM(cfg, dtype)
    p = p.to_empty(device=resolve_device(device))
    dense_init(p.embed, cfg.d_model, generator, scale=0.02)
    for layer in p.layers:
        init_decoder_layer(layer, cfg, generator)
    p.final_norm.zero_()
    if p.lm_head is not None:
        dense_init(p.lm_head.weight, cfg.d_model, generator)
    return p


def _layer_output(layer: DecoderLayer, cfg: ModelConfig, h: torch.Tensor,
                  positions: Optional[torch.Tensor], spec: MaskSpec
                  ) -> Tuple[torch.Tensor, Any]:
    h, _, aux = decoder_layer(layer, cfg, h, positions, spec)
    return h, aux


def remat_apply(module: nn.Module, fn, *args):
    """fn(module, *args) with only its inputs saved for backward (the
    reference's `jax.checkpoint` with `nothing_saveable`).  The module must
    be `_Applied`.  Its weights are checkpoint inputs, swapped in through
    `torch.func.functional_call`, so the recomputation sees the ones this
    forward saw, also after an outer swap (the trainer's compute copy) has
    ended.  The recomputation runs in the span `train.recompute`."""
    names, weights = zip(*module.named_parameters())
    n = len(args)

    def run(*xs):
        return torch.func.functional_call(
            module, dict(zip(names, xs[n:])), (fn, *xs[:n]))
    return checkpoint(run, *args, *weights, use_reentrant=False,
                      context_fn=_recompute_contexts)


def _recompute_contexts():
    """checkpoint's (forward, recomputation) contexts: the recomputation in
    the span `train.recompute` (a no-op while the recorder is off)."""
    return contextlib.nullcontext(), obs.span("train.recompute")


def decoder_stack(params: DecoderLM, cfg: ModelConfig, h: torch.Tensor,
                  positions: Optional[torch.Tensor],
                  caches: Optional[Caches] = None,
                  cache_index: Optional[int] = None,
                  cache_positions: Optional[torch.Tensor] = None,
                  prefix_len: int = 0, remat: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[Caches], Any]:
    """Run the layer stack.  caches: stacked (k, v) [L, B, T, Hkv, D],
    written in place.  remat: recompute each layer in backward (training;
    no caches).  Returns (h, caches, aux): aux sums the layers' MoE
    load-balancing losses (0.0 for the dense family); serving discards
    it."""
    specs = layer_specs(cfg)
    if prefix_len:
        specs = tuple(
            MaskSpec(causal=s.causal, window=s.window, prefix_len=prefix_len)
            for s in specs)
    if remat and caches is not None:
        raise ValueError("remat is for training, which runs without caches")
    aux_sum = 0.0
    for i, layer in enumerate(params.layers):
        spec = specs[i % len(specs)]
        if remat:
            h, aux = remat_apply(layer, _layer_output, cfg, h, positions,
                                 spec)
        else:
            cache = None if caches is None else (caches[0][i], caches[1][i])
            h, _, aux = decoder_layer(layer, cfg, h, positions, spec,
                                      cache, cache_index, cache_positions)
        h = constrain(h, "residual")
        aux_sum = aux_sum + aux
    return h, caches, aux_sum


def _embed_sharded(embed: DTensor, tokens: torch.Tensor) -> DTensor:
    """Rows of a DTensor embedding [V, d], looked up on local tensors: the
    embedding gathered over every mesh dim but "model", where its vocab
    may be split; each rank looks up the tokens of its own vocab rows and
    zeroes the others, so the rows are a partial sum over "model" (reduced
    here).  The tokens (a DTensor, rows over the batch axes, or a plain
    tensor, replicated) keep their row placements.  The embedding's
    gradient is then a partial sum over the axes the rows split."""
    mesh = embed.device_mesh
    tok_pl = tokens.placements if isinstance(tokens, DTensor) else \
        [Replicate()] * mesh.ndim
    tok = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    w_pl, grad_pl, out_pl = [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        if name == "model":
            w_pl.append(embed.placements[i])
            grad_pl.append(embed.placements[i])
            out_pl.append(Partial() if embed.placements[i].is_shard()
                          else Replicate())
        else:
            rows = tok_pl[i]
            w_pl.append(Replicate())
            grad_pl.append(Partial() if rows.is_shard() else Replicate())
            out_pl.append(rows)
    w = embed
    if tuple(w.placements) != tuple(w_pl):
        w = w.redistribute(mesh, w_pl)
    w = w.to_local(grad_placements=grad_pl)
    if "model" in mesh.mesh_dim_names and \
            embed.placements[mesh.mesh_dim_names.index("model")].is_shard():
        rows = w.shape[0]
        ids = tok - mesh.get_local_rank("model") * rows
        outside = (ids < 0) | (ids >= rows)
        h = w[torch.where(outside, 0, ids)]
        h = torch.where(outside[..., None], torch.zeros((), dtype=h.dtype,
                                                        device=h.device), h)
    else:
        h = w[tok]
    return _settled(DTensor.from_local(h, mesh, out_pl, run_check=False))


def embed_tokens(params: DecoderLM, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding; a DTensor embedding through
    `_embed_sharded`."""
    if isinstance(params.embed, DTensor):
        h = _embed_sharded(params.embed, tokens)
    else:
        h = params.embed[tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(h.dtype)
    return constrain(h, "residual")


def _project(cfg: ModelConfig, h: torch.Tensor, final_norm: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """fp32 logits of h under the final norm and the [V, d] output
    projection, with the final softcap."""
    h = unsplit_sequence(rms_norm(h, final_norm, cfg.norm_eps))
    logits = constrain(h @ _unshard_vocab_split(w_out).T, "logits")
    return softcap(logits.float(), cfg.final_logit_softcap)


def _unshard_vocab_split(w_out: torch.Tensor) -> torch.Tensor:
    """`unshard` for an output projection [V, d] whose vocab is split over
    "model".  One whose vocab is not (whisper's 51865, mamba2's 50280 on
    16) stays split over "data": gathered whole, every "model" rank would
    compute every logit of its rows (16x the FLOPs and ~30 GiB a device
    at train_4k), where DTensor's own choice keeps them split."""
    from torch.distributed.tensor import DTensor
    if isinstance(w_out, DTensor) and "model" in \
            w_out.device_mesh.mesh_dim_names and w_out.placements[
                w_out.device_mesh.mesh_dim_names.index("model")].is_shard():
        return unshard(w_out)
    return w_out


def _output_weight(params: DecoderLM) -> torch.Tensor:
    return params.embed if params.lm_head is None else params.lm_head.weight


def lm_logits(params: DecoderLM, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    """fp32 logits, with the final softcap."""
    return _project(cfg, h, params.final_norm, _output_weight(params))


# ---------------------------------------------------------------------- #
# training loss
# ---------------------------------------------------------------------- #

LOSS_CHUNK = 512   # sequence positions per logits chunk


def _settled(t: torch.Tensor) -> torch.Tensor:
    """t with every partial placement of a DTensor reduced (a gather from
    vocab-sharded logits is a masked partial sum over "model")."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def _gold_sharded(logits: DTensor, safe: torch.Tensor) -> DTensor:
    """logits[..., safe] of DTensor logits [B,c,V] whose vocab is split
    over "model", on local tensors: each rank picks the labels in its own
    vocab rows and zeroes the others, a partial sum over "model" (reduced
    here).  DTensor's own gather would do the same forward, but its
    backward allocates the whole [B,c,V] gradient on every rank."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    lab_pl, out_pl = [], []
    for i, name in enumerate(names):
        if name == "model":
            lab_pl.append(Replicate())
            out_pl.append(Partial())
        else:
            rows = logits.placements[i]
            lab_pl.append(rows)
            out_pl.append(rows)
    lab = safe if isinstance(safe, DTensor) else DTensor.from_local(
        safe, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lab = _placed(lab, lab_pl).to_local()
    local = logits.to_local()
    vl = local.shape[-1]
    ids = lab - mesh.get_local_rank("model") * vl
    inside = (ids >= 0) & (ids < vl)
    g = torch.gather(local, -1, torch.where(inside, ids, 0)[..., None])
    g = torch.where(inside[..., None], g, torch.zeros((), dtype=g.dtype,
                                                      device=g.device))
    return _settled(DTensor.from_local(g, mesh, out_pl, run_check=False))


def _vocab_split(logits: torch.Tensor) -> bool:
    """A DTensor whose last dim is split over "model" and over nothing
    else, with no partial placement."""
    if not isinstance(logits, DTensor):
        return False
    last = logits.dim() - 1
    for n, p in zip(logits.device_mesh.mesh_dim_names, logits.placements):
        on_vocab = p.is_shard() and p.dim in (-1, last)
        if p.is_partial() or on_vocab != (n == "model"):
            return False
    return True


def _logsumexp_sharded(logits: DTensor) -> DTensor:
    """logsumexp over the last dim of DTensor logits [B,c,V] whose vocab
    is split over "model", on local tensors: each rank's max is
    all-reduced (max), then its sum of exponentials (sum), [B, c] each.
    DTensor's own logsumexp gathers the whole float32 logits on every
    rank.  The result keeps the logits' row placements."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    rows = [Replicate() if n == "model" else p
            for n, p in zip(names, logits.placements)]

    def over_model(t: torch.Tensor, op: str) -> DTensor:
        return DTensor.from_local(t, mesh, [
            Partial(op) if n == "model" else p for n, p in zip(names, rows)],
            run_check=False).redistribute(mesh, rows)

    local = logits.to_local()
    m = over_model(local.detach().amax(dim=-1), "max").to_local()
    sums = over_model(torch.exp(local - m[..., None]).sum(dim=-1), "sum")
    return torch.log(sums) + DTensor.from_local(m, mesh, rows,
                                                run_check=False)


def _chunk_nll(cfg: ModelConfig, hc: torch.Tensor, lc: torch.Tensor,
               final_norm: torch.Tensor, w_out: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = _project(cfg, hc, final_norm, w_out)             # [B,c,V] f32
    valid = lc != -100
    safe = torch.where(valid, lc, 0)
    if _vocab_split(logits):
        # one "model" rank holds the whole vocab: the plain path's op
        mesh = logits.device_mesh
        logz = torch.logsumexp(logits, dim=-1) if mesh.size(
            mesh.mesh_dim_names.index("model")) == 1 else \
            _logsumexp_sharded(logits)
        gold = _gold_sharded(logits, safe)[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = _settled(torch.gather(logits, -1, safe[..., None]))[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def next_token_loss(params: DecoderLM, cfg: ModelConfig, h: torch.Tensor,
                    tokens: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Next-token cross-entropy WITHOUT materialising [B,S,V] logits: the
    vocab projection + softcap + CE run chunked over the sequence, each
    chunk recomputed in the backward pass.  At a 256k vocab the full fp32
    logits of a 4 x 512 batch are 2.1 GB per chunk of 512 positions; chunking
    caps live logits at LOSS_CHUNK/S of the whole."""
    b, s = tokens.shape
    labels = torch.cat([tokens[:, 1:].long(),
                        torch.full((b, 1), -100, dtype=torch.long,
                                   device=tokens.device)], dim=1)
    if loss_mask is not None:
        labels = torch.where(loss_mask > 0, labels, -100)
    c = min(LOSS_CHUNK, s)
    pad = (-s) % c
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-100)
    final_norm, w_out = params.final_norm, _output_weight(params)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.long, device=h.device)
    for i in range(0, s + pad, c):
        dn, dc = checkpoint(_chunk_nll, cfg, h[:, i:i + c],
                            labels[:, i:i + c], final_norm, w_out,
                            use_reentrant=False)
        nll = nll + dn
        cnt = cnt + dc
    return nll / torch.clamp(cnt, min=1)


def lm_loss(params: DecoderLM, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], prefix_len: int = 0,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens [B,S] int (+ optional loss_mask [B,S]).
    Returns (total, token loss): the total adds 0.01 * the layers' summed
    MoE load-balancing loss (0.0 for the dense family, so the two are
    equal there), as the reference does."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    h, _, aux = decoder_stack(params, cfg, h, None, prefix_len=prefix_len,
                              remat=remat)
    loss = next_token_loss(params, cfg, h, tokens, batch.get("loss_mask"))
    return loss + 0.01 * aux, loss


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
                   dtype=torch.float32, device="cuda") -> Caches:
    """Zeroed stacked caches on `device`: the card unless the caller asks
    for the CPU."""
    device = resolve_device(device)
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
    h, caches, _ = decoder_stack(params, cfg, h, None, caches=caches,
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
    h, caches, _ = decoder_stack(
        params, cfg, h, positions, caches=caches, cache_index=index % clen,
        cache_positions=ring_positions(index, clen, token.device))
    return lm_logits(params, cfg, h), caches
