"""The training step: loss -> grad -> (optional gradient reduction) ->
AdamW, with microbatch gradient accumulation and a dtype policy.
Counterpart of src/repro/train/train_step.py.

The parameters are float32 masters.  Each microbatch runs the model through
`torch.func.functional_call` on a copy of the parameters cast once to the
compute dtype (`cast_params`), so the gradients land in float32 on the
masters, as the reference's `cast_params` + `value_and_grad` gives them.
The batch goes to the parameters' device, its floating-point entries (the
vlm and audio frontends' embeddings) cast to the compute dtype.
The `grad_reduce` hook is where data parallelism plugs in: the paper's
tree-pipeline allreduce (`repro_torch.comms.BucketedAllReduce`) or
`torch.distributed.all_reduce`.

Each microbatch's forward and backward passes run in the spans
`train.forward` and `train.backward` (repro_torch.obs), AdamW in
`train.adamw`.

Under FSDP+TP the parameters, their AdamW state and the batch are DTensors
(repro_torch.launch.sharding): the batch rows over the data axis, and each
gradient, which comes back as a partial sum over the data axis, is
redistributed to its parameter's placements (a reduce-scatter), so no
`grad_reduce` hook runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import obs
from repro_torch.models.model_zoo import Model

from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw

Grads = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1                 # grad accumulation steps
    compute_dtype: Any = torch.float32    # bf16 on the card


def cast_params(params: nn.Module, dtype) -> Grads:
    """The floating-point parameters cast to `dtype` (differentiably; a
    parameter already in `dtype` is itself)."""
    return {n: p.to(dtype) if p.is_floating_point() else p
            for n, p in params.named_parameters()}


def _rows(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch i of n: rows [i * b / n, (i + 1) * b / n) of v, or of
    each rank's own rows of a DTensor (the same average over the n)."""
    if n == 1:
        return v
    if isinstance(v, DTensor):
        local = v.to_local()
        b = local.shape[0]
        return DTensor.from_local(local[i * b // n:(i + 1) * b // n],
                                  v.device_mesh, v.placements,
                                  run_check=False)
    b = v.shape[0]
    return v[i * b // n:(i + 1) * b // n]


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed_grad(p: torch.Tensor) -> torch.Tensor:
    """p's gradient; a DTensor's in p's own placements."""
    g = p.grad
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grad(model: Model, params: nn.Module,
                  batch: Dict[str, torch.Tensor], cfg: TrainConfig
                  ) -> Tuple[torch.Tensor, Grads, torch.Tensor]:
    """Returns (loss, grads, token loss), averaged over microbatches.  The
    grads are the parameters' `.grad` tensors, float32, in module order."""
    for p in params.parameters():
        p.grad = None
    n = max(cfg.microbatches, 1)
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    device = next(params.parameters()).device
    loss = torch.zeros((), dtype=torch.float32, device=device)
    tok = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(n):
        with obs.span("train.forward"):
            mb = {k: _rows(v, i, n).to(
                      device, cfg.compute_dtype if v.is_floating_point()
                      else v.dtype) for k, v in batch.items()}
            cast = cast_params(params, cfg.compute_dtype)
            total, token_loss = torch.func.functional_call(
                params, cast, (model.loss, mb))
            del cast
        # remat's recomputation runs here
        with obs.span("train.backward"), implicit_replication():
            total.backward()
        loss = loss + _whole(total.detach().float())
        tok = tok + _whole(token_loss.detach().float())
    grads = {name: _placed_grad(p) for name, p in params.named_parameters()}
    if n > 1:
        for g in grads.values():
            g.div_(n)
    return loss / n, grads, tok / n


def make_train_step(model: Model, cfg: TrainConfig,
                    grad_reduce: Optional[Callable[[Grads], Grads]] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    updating params and opt_state in place.

    grad_reduce: optional callable applied to the gradient dict before the
    optimizer — the hook where the paper's tree-pipeline allreduce plugs in.
    It also reduces the scalar loss, as {"loss": loss}."""

    def train_step(params: nn.Module, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[nn.Module, AdamWState, Dict[str, Any]]:
        loss, grads, tok = loss_and_grad(model, params, batch, cfg)
        if grad_reduce is not None:
            grads = grad_reduce(grads)
            loss = grad_reduce({"loss": loss})["loss"]
        params, opt_state, metrics = adamw_update(
            cfg.optimizer, grads, opt_state, params)
        for p in params.parameters():
            p.grad = None
        metrics = dict(metrics, loss=loss, token_loss=tok)
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, seed: int, device="cuda"
                     ) -> Tuple[nn.Module, AdamWState]:
    """float32 master parameters from `seed` on `device`, and fresh AdamW
    state."""
    params = model.init(seed, torch.float32, device)
    return params, init_adamw(params)
