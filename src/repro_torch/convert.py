"""Carry weights across from the JAX reference.

`from_jax_params(cfg, tree)` takes the reference's dense-LM param pytree as
nested dicts of numpy arrays, layers stacked [L, ...], and returns the port's
`DecoderLM` with the same weights: the layers are split, and every 2-D weight
inside a layer, and the untied lm_head, is transposed into `nn.Linear`'s
[out, in] layout.  The embedding keeps its [V, d] layout.  The result lies
on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.common import ModelConfig, resolve_device
from .models.transformer import DecoderLM


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, as jax gives
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(a)                  # a copy: jax's arrays are read-only


def _linear(a: Any) -> torch.Tensor:
    return _tensor(a).T.contiguous()


def _layer_entries(prefix: str, tree: Mapping, i: int,
                   out: Dict[str, torch.Tensor]) -> None:
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            _layer_entries(key + ".", leaf, i, out)
        elif np.ndim(leaf) == 3:            # [L, in, out] -> nn.Linear
            out[key + ".weight"] = _linear(leaf[i])
        else:                               # [L, d] norm weights
            out[key] = _tensor(leaf[i])


def from_jax_params(cfg: ModelConfig, tree: Mapping,
                    device="cuda") -> DecoderLM:
    """The port's DecoderLM with the weights of `tree`, on `device`: the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {
        "embed": _tensor(tree["embed"]),
        "final_norm": _tensor(tree["final_norm"]),
    }
    if "lm_head" in tree:
        sd["lm_head.weight"] = _linear(tree["lm_head"])
    for i in range(cfg.num_layers):
        _layer_entries(f"layers.{i}.", tree["layers"], i, sd)
    with torch.device("meta"):
        p = DecoderLM(cfg, sd["embed"].dtype)
    p.load_state_dict(sd, strict=True, assign=True)
    return p.to(device)
