"""Model FLOPs of a train step, frozen here so that the yardstick does not
move with the program: a change that removes operations from the program
does not lower what a step is counted to need.

Counted: the matmuls of each Mamba2 mixer (in_proj, out_proj and the
chunked SSD's products: C.B^T over the causal half of each chunk, shared
by the heads; its product with x dt; each chunk's state; the carried
state's read-out) and the tied output head.  Not counted: the embedding
lookup, norms, convolutions and elementwise work, and recomputation.  The
backward pass is twice the forward, so a step is three forwards.
"""
from __future__ import annotations

from typing import Any, Dict


def mixer_flops_per_token(cfg: Dict[str, Any]) -> float:
    d = cfg["d_model"]
    din = cfg["ssm_expand"] * d
    n, p, q = cfg["ssm_state_dim"], cfg["ssm_head_dim"], cfg["ssm_chunk"]
    h = din // p
    proj = 2 * d * (2 * din + 2 * n + h) + 2 * din * d
    ssd = 2 * (q / 2) * n + h * (2 * (q / 2) * p + 2 * p * n + 2 * n * p)
    return proj + ssd


def forward_flops_per_token(cfg: Dict[str, Any], seq: int) -> float:
    return cfg["num_layers"] * mixer_flops_per_token(cfg) \
        + 2 * cfg["d_model"] * cfg["vocab_size"]


def train_step_flops(cfg: Dict[str, Any], batch: int, seq: int) -> float:
    """Forward and backward of one step over batch x seq tokens."""
    if cfg["family"] != "ssm":
        raise ValueError(f"no FLOP formula for family {cfg['family']!r}")
    return 3 * forward_flops_per_token(cfg, seq) * batch * seq
