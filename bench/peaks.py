"""The yardstick's peaks: one NVIDIA H100 SXM5 80 GB at its full power
limit of 700 W, dense rates without sparsity (NVIDIA's data sheet; the
same values as the port's `topo/hardware.py:H100_SXM`, copied so that the
yardstick does not move with the program).  A card set below 700 W runs
below them; the drivers print the card's power limit beside the run."""
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, CUDA cores
HBM_BYTES_PER_S = 3.35e12       # bytes/s, HBM3
