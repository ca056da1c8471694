"""AdamW on named parameters.  Counterpart of src/repro/train/optimizer.py.

The state's `mu` and `nu` are float32 dicts keyed like the parameters.  The
parameters are the float32 masters (the trainer computes with a cast copy),
so the reference's separate `master` copy has no counterpart.  Updates are in
place: `adamw_update` overwrites the parameters, the moments and the
gradients it is given, which saves a copy of each.

DTensor parameters (FSDP+TP, repro_torch.launch.sharding) take the same
path: each rank updates its own shards, their moments carry the same
placements, and the global norm sums every leaf's whole norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import obs

Grads = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    mu: Grads
    nu: Grads


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_adamw(params: nn.Module) -> AdamWState:
    mu = {n: torch.zeros_like(p, dtype=torch.float32)
          for n, p in params.named_parameters()}
    nu = {n: torch.zeros_like(p, dtype=torch.float32)
          for n, p in params.named_parameters()}
    return AdamWState(step=0, mu=mu, nu=nu)


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio, in float32 as the
    reference computes it."""
    f = np.float32
    warm = min(f(1.0), f(step + 1) / f(max(cfg.warmup_steps, 1)))
    frac = np.clip(f(step - cfg.warmup_steps)
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * frac))
    return float(f(cfg.lr) * warm
                 * (f(cfg.min_lr_ratio) + (f(1) - f(cfg.min_lr_ratio)) * cos))


def global_norm(tree: Grads) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32.  The norm
    of a DTensor leaf is reduced over its mesh to one replicated value."""
    norms = [torch.linalg.vector_norm(x.float()) for x in tree.values()]
    norms = [n.full_tensor() if isinstance(n, DTensor) else n for n in norms]
    return torch.linalg.vector_norm(torch.stack(norms))


def adamw_update(cfg: AdamWConfig, grads: Grads, state: AdamWState,
                 params: nn.Module) -> Tuple[nn.Module, AdamWState,
                                             Dict[str, object]]:
    """One AdamW step with global-norm clipping and decoupled weight decay
    (none on 1-D weights: norms).  Updates params (float32), the moments
    and the grads in place.  Returns (params, new_state, metrics).  Runs
    in the span `train.adamw`."""
    with obs.span("train.adamw"):
        return _adamw_update(cfg, grads, state, params)


def _adamw_update(cfg: AdamWConfig, grads: Grads, state: AdamWState,
                  params: nn.Module) -> Tuple[nn.Module, AdamWState,
                                              Dict[str, object]]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    f = np.float32
    b1c = float(f(1) - f(cfg.b1) ** f(step))
    b2c = float(f(1) - f(cfg.b2) ** f(step))
    with torch.no_grad(), implicit_replication():
        for name, p in params.named_parameters():
            g = grads[name].float().mul_(scale)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
            if p.ndim >= 2:
                delta.add_(cfg.weight_decay * p.float())
            p.sub_(lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics
