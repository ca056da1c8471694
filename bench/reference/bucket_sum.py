"""The gradient-sync cells' inputs and their plain reference.

Rank r's gradients of bucket b are one float32 standard-normal draw of the
bucket's elements from (seed, "grad", r, b), cut into the bucket's
tensors in order; the reference is their sum over the ranks, accumulated
in float64.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from bench.seeds import generator

Shapes = Dict[str, Tuple[int, ...]]


def _draw(out: torch.Tensor, seed: int, rank: int, bucket: int
          ) -> torch.Tensor:
    return out.normal_(generator=generator(out.device, seed, "grad", rank,
                                           bucket))


def bucket_inputs(seed: int, bucket: int, names: Sequence[str],
                  shapes: Shapes, ranks: List[int], device,
                  stacked: bool, flat: bool = False):
    """The bucket's tensors of `ranks`: {name: [len(ranks), *shape]} when
    stacked, else {name: shape} of the one rank; `flat` returns the
    underlying [len(ranks), n] or [n] buffer instead."""
    n = sum(math.prod(shapes[k]) for k in names)
    buf = torch.empty((len(ranks), n) if stacked else (n,),
                      dtype=torch.float32, device=device)
    for i, r in enumerate(ranks):
        _draw(buf[i] if stacked else buf, seed, r, bucket)
    if flat:
        return buf
    lead = (len(ranks),) if stacked else ()
    out, at = {}, 0
    for k in names:
        m = math.prod(shapes[k])
        out[k] = buf[..., at:at + m].view(lead + tuple(shapes[k]))
        at += m
    return out


def rank_sum(seed: int, bucket: int, names: Sequence[str], shapes: Shapes,
             ranks: int, device) -> torch.Tensor:
    """The bucket's flat sum over `ranks` ranks, float64 [n]."""
    n = sum(math.prod(shapes[k]) for k in names)
    total = torch.zeros(n, dtype=torch.float64, device=device)
    row = torch.empty(n, dtype=torch.float32, device=device)
    for r in range(ranks):
        total += _draw(row, seed, r, bucket)
    return total
