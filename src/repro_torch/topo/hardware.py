"""The card's roofline constants: counterpart of the reference's
`HardwareSpec` / `TPU_V5E` (src/repro/topo/tpu.py), for an NVIDIA H100.

Every value is the data sheet's for the H100 SXM5 80 GB part at its full
power limit, dense rates without sparsity; the card these numbers serve is
the one `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
prints as "NVIDIA H100 80GB HBM3, 700.00 W".  A card set below 700 W runs
slower under load than these peaks say.

    compute term    = flops per device / peak_flops_bf16
    memory term     = bytes per device / hbm_bw
    collective term = collective bytes per device / the slowest link
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # per card, FLOP/s (tensor cores, dense)
    peak_flops_f32: float       # per card, FLOP/s (CUDA cores, no tensor cores)
    hbm_bw: float               # per card, bytes/s
    hbm_bytes: float            # per card HBM capacity
    nvlink_bw: float            # per card, bytes/s per direction, in a node
    nic_bw: float               # per card, bytes/s per direction, between nodes
    smem_bytes: float           # shared memory per SM
    gpus_per_node: int = 8      # cards an NVLink switch joins


H100_SXM = HardwareSpec(
    name="h100-sxm5-80gb",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    # torch.cuda.get_device_properties(0).total_memory on an "NVIDIA H100
    # 80GB HBM3, 700.00 W" (chip_smoke.py's dryrun_cards phase prints it)
    hbm_bytes=85_017_493_504,
    nvlink_bw=450e9,            # NVLink 4: 900 GB/s both directions
    nic_bw=50e9,                # one 400 Gb/s NIC per GPU
    smem_bytes=228 * 1024,
)
