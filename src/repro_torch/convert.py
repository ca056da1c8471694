"""Carry weights across from the JAX reference.

`from_jax_params(cfg, tree)` takes the reference's param pytree (the dense,
moe and vlm families' `init_lm`, `init_encdec`, `init_ssm_lm` or
`init_hybrid_lm`) as nested dicts of numpy arrays, layers stacked [L, ...],
and returns the port's module of the config's family with the same weights.
The stacked `layers` (and whisper's `enc_layers` and `dec_layers`) are
split; every leaf whose port counterpart is an `nn.Linear` (the
projections, cross-attention's among them, an MoE block's shared expert,
and the untied lm_head) is
transposed into its [out, in] layout; every other leaf keeps its layout:
the embedding [V, d], the norms, Mamba2's conv taps [W, C] and its per-head
vectors, and an MoE block's router [d, E], expert tensors [E, d, ff] /
[E, ff, d] and shared_gate [d, 1].  Unstacked subtrees (zamba2's one
`shared` block) are carried across as they are.  The result lies on the
card unless the caller passes device="cpu".
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .models.common import ModelConfig, resolve_device
from .models.encdec import EncDecLM
from .models.hybrid import HybridLM, SSMLM
from .models.transformer import DecoderLM

_MODULES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
            "audio": EncDecLM, "ssm": SSMLM, "hybrid": HybridLM}


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, as jax gives
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(a)                  # a copy: jax's arrays are read-only


def _entries(prefix: str, tree: Mapping, layer: Optional[int],
             targets: set, out: Dict[str, torch.Tensor]) -> None:
    """Leaves of `tree` into `out` under the port's names; `layer` picks
    one slice of stacked leaves."""
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            _entries(key + ".", leaf, layer, targets, out)
            continue
        value = _tensor(leaf if layer is None else np.asarray(leaf)[layer])
        if key + ".weight" in targets:      # [in, out] -> nn.Linear
            out[key + ".weight"] = value.T.contiguous()
        elif key in targets:
            out[key] = value
        else:
            raise KeyError(f"{key}: no counterpart in the port's module")


def from_jax_params(cfg: ModelConfig, tree: Mapping,
                    device="cuda") -> nn.Module:
    """The port's DecoderLM (dense, moe, vlm), EncDecLM, SSMLM or HybridLM
    with the weights of `tree`, on `device`: the card unless the caller asks
    for the CPU."""
    device = resolve_device(device)
    embed = _tensor(tree["embed"])
    with torch.device("meta"):
        p = _MODULES[cfg.family](cfg, embed.dtype)
    targets = set(p.state_dict())
    stacked = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers,
               "dec_layers": cfg.num_layers}
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if name in stacked:
            for i in range(stacked[name]):
                _entries(f"{name}.{i}.", leaf, i, targets, sd)
        elif isinstance(leaf, Mapping):
            _entries(name + ".", leaf, None, targets, sd)
        else:
            _entries("", {name: leaf}, None, targets, sd)
    p.load_state_dict(sd, strict=True, assign=True)
    return p.to(device)
