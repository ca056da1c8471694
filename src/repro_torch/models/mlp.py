"""MLPs: gated (SwiGLU / GeGLU) and plain (fc1/fc2).  Counterpart of
src/repro/models/mlp.py."""
from __future__ import annotations

import torch
from torch import nn

from .common import activation_fn, dense_init, linear, unsplit_sequence


class MLP(nn.Module):
    """Bias-free `nn.Linear`s ([out, in] weights): w_gate, w_up, w_down for
    the gated variant, w_in, w_out for the plain one."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, variant: str = "gated"):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.variant = variant
        if variant == "plain":
            self.w_in = nn.Linear(d_model, d_ff, **kw)
            self.w_out = nn.Linear(d_ff, d_model, **kw)
        else:
            self.w_gate = nn.Linear(d_model, d_ff, **kw)
            self.w_up = nn.Linear(d_model, d_ff, **kw)
            self.w_down = nn.Linear(d_ff, d_model, **kw)


@torch.no_grad()
def init_mlp(p: MLP, generator: torch.Generator) -> None:
    for lin in p.children():
        dense_init(lin.weight, lin.in_features, generator)


def mlp_forward(p: MLP, x: torch.Tensor, activation: str = "silu"
                ) -> torch.Tensor:
    act = activation_fn(activation)
    x = unsplit_sequence(x)
    if p.variant == "plain":
        return linear(p.w_out, act(linear(p.w_in, x)))
    return linear(p.w_down, act(linear(p.w_gate, x)) * linear(p.w_up, x))
