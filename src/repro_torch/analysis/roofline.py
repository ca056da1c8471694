"""Roofline terms of one dry-run cell against the card.  Counterpart of
src/repro/analysis/roofline.py, with an H100 in place of the TPU.

Three terms per (arch x shape x mesh), in seconds, from the per-device
counts of `hlo_count` (so per-device counts over per-card peaks):

    compute    = flops per device / peak bf16 FLOP/s
    memory     = bytes per device / HBM bytes/s
    collective = collective wire bytes per device / the slowest link

The collective term charges every byte to the slowest link its axis
crosses.  A 16-wide mesh axis of 8-GPU nodes leaves its node, so that link
is one NIC per GPU (`HardwareSpec.nic_bw`), as the reference worst-cases
axes it cannot place as ICI.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.topo.hardware import H100_SXM, HardwareSpec


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                # per-device
    hlo_bytes: float                # per-device HBM traffic
    collective_bytes: Dict[str, int]  # per-device, by kind
    model_flops: float              # 6·N·D (or 6·N_active·D) total
    hw: HardwareSpec = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.hw.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    @property
    def collective_s(self) -> float:
        # per-device collective bytes over the per-device egress of the
        # slowest link crossed
        return self.total_collective_bytes / self.hw.nic_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (per-device FLOPs × chips): the counted compute's
        efficiency -- catches remat recompute and masked-attention waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / max(all terms): 1.0 = perfectly compute-bound."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.hlo_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_bytes": dict(self.collective_bytes),
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training (D = tokens per step); 2·N·D for a
    forward-only step (prefill); decode: 2·N_active per token × batch."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
