"""AdamW on named parameters.  Counterpart of src/repro/train/optimizer.py.

The state's `mu` and `nu` are float32 dicts keyed like the parameters.  The
parameters are the float32 masters (the trainer computes with a cast copy),
so the reference's separate `master` copy has no counterpart.  Updates are in
place: `adamw_update` overwrites the parameters and the moments, and
consumes the gradients it is given: their values afterwards are
unspecified (every caller drops them).

Which path runs is decided from the input, by `_on_kernel`:

* every parameter a plain CUDA tensor, and no dispatch mode active: the
  multi-tensor kernel (`kernels/adamw.py`, library `adamw`): the global
  norm and the clip scale stay on the device, and every element of every
  tensor is updated in two launches (for up to `kernels.adamw.MAX_TENSORS`
  tensors).  Each gradient and moment must then be a contiguous float32
  tensor of its parameter's shape on that device: anything else raises,
  naming the parameter;
* CPU tensors, DTensors (FSDP+TP, `repro_torch.launch.sharding`, and the
  dry run's fake ones) and tensors under a dispatch mode (fake tensors,
  `analysis.hlo_count`'s counter): the loop over the tensors (`_loop`).

Both run the reference's float32 operations in its order: g * scale, mu *
b1 + (1 - b1) g, nu * b2 + ((1 - b2) g) g, (mu / b1c) / (sqrt(nu / b2c) +
eps), + weight_decay p on tensors of 2 or more dimensions, p - lr delta;
on the card the kernel is bit-equal to the loop from the same scale.  They
share only `lr_schedule` and `_bias_corrections`.  `UPDATED` counts the
elements each path updated.

Under DTensor each rank updates its own shards, their moments carry the
same placements, and the global norm sums every leaf's whole norm.
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
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import obs
from repro_torch.kernels import adamw as adamw_kernel

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


class Updated:
    """Elements updated by each path of `adamw_update` (a DTensor's whole
    count), counted as a kernel wrapper counts launches."""

    def __init__(self) -> None:
        self.kernel = 0
        self.loop = 0


UPDATED = Updated()


def _bias_corrections(cfg: AdamWConfig, step: int) -> Tuple[float, float]:
    f = np.float32
    return (float(f(1) - f(cfg.b1) ** f(step)),
            float(f(1) - f(cfg.b2) ** f(step)))


def adamw_update(cfg: AdamWConfig, grads: Grads, state: AdamWState,
                 params: nn.Module) -> Tuple[nn.Module, AdamWState,
                                             Dict[str, object]]:
    """One AdamW step with global-norm clipping and decoupled weight decay
    (none on 1-D weights: norms).  Updates params (float32) and the
    moments in place and consumes the grads.  Returns (params, new_state,
    metrics); metrics["grad_norm"] is a 0-dim tensor on the parameters'
    device.  Runs in the span `train.adamw`."""
    with obs.span("train.adamw"):
        named = list(params.named_parameters())
        step = state.step + 1
        lr = lr_schedule(cfg, state.step)
        b1c, b2c = _bias_corrections(cfg, step)
        if _on_kernel(named):
            out, n = adamw_kernel.step(
                [(name, p, grads[name], state.mu[name], state.nu[name])
                 for name, p in named], cfg.grad_clip,
                adamw_kernel.constants(cfg.b1, cfg.b2, cfg.eps,
                                       cfg.weight_decay, lr, b1c, b2c))
            UPDATED.kernel += n
            gnorm = out[0]
        else:
            gnorm = global_norm(grads)
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            _loop(cfg, grads, state, named, scale, lr, b1c, b2c)
            UPDATED.loop += sum(p.numel() for _, p in named)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics


def _on_kernel(named) -> bool:
    """The kernel path: plain CUDA parameters and no dispatch mode (which
    must see every op: fake tensors, a counter)."""
    return (bool(named) and _get_current_dispatch_mode() is None
            and not any(isinstance(p, DTensor) for _, p in named)
            and named[0][1].is_cuda)


def _loop(cfg: AdamWConfig, grads: Grads, state: AdamWState, named,
          scale: torch.Tensor, lr: float, b1c: float, b2c: float) -> None:
    """The update tensor by tensor from `scale`, in place (the grads
    too)."""
    with torch.no_grad(), implicit_replication():
        for name, p in named:
            g = grads[name].float().mul_(scale)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
            if p.ndim >= 2:
                delta.add_(cfg.weight_decay * p.float())
            p.sub_(lr * delta)
