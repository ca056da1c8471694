"""Hand-written Hopper kernels of the port, each with its plain version.

    flash_attention  csrc/flash_attention.cu  (replaces the Pallas
                     src/repro/kernels/flash_attention.py)
    chunk_accum      csrc/chunk_accum.cu      (replaces the Pallas
                     src/repro/kernels/chunk_accum.py)
    ssd_chunk        csrc/ssd_chunk.cu        (replaces the Pallas
                     src/repro/kernels/ssd_scan.py; its backward, a
                     second entry point, replaces none)
    ssd_state        csrc/ssd_state.cu        (steps 3 and 4 of the chunked
                     SSD, forward and backward; replace no Pallas kernel)
    adamw            csrc/adamw.cu            (AdamW's global norm and
                     update over every tensor, two launches; replaces no
                     Pallas kernel: `train/optimizer.py` calls it)

Kernels build with nvcc at first launch (`build.py`), never at import.
flash_attention, ssd_chunk and ssd_state (forward and backward) run
through custom ops (`KERNEL_OPS`), each with a fake implementation and a FLOP formula, so
fake tensors (the dry run) reach them and `analysis.hlo_count` counts them.

The models reach them through `ops`: `flash_attention_bshd`, and
`ssd_chunked_bshp`, the chunked SSD's one entry (its layout and dtypes;
`SSDChunked` under autograd).  The kernels' own layouts are the wrappers'
`flash_attention`, `chunk_accum`, `chunk_accum_indexed`,
`ssd_chunk_intra_heads` / `ssd_chunk_intra_bwd_heads` (steps 1-2),
`ssd_state_heads` / `ssd_state_bwd_heads` (steps 3-4) and
`ssd_chunk_intra` (the Pallas kernel's layout).
"""
import torch

from .chunk_accum import KERNEL as CHUNK_ACCUM_KERNEL  # noqa: F401
from .chunk_accum import chunk_accum, chunk_accum_indexed  # noqa: F401
from .flash_attention import KERNEL as FLASH_KERNEL  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .ops import flash_attention_bshd, ssd_chunked_bshp  # noqa: F401
from .ref import (chunk_accum_indexed_reference,  # noqa: F401
                  chunk_accum_reference, mha_reference, ssd_chunk_reference)
from .ssd_scan import BWD_KERNEL as SSD_BWD_KERNEL  # noqa: F401
from .ssd_scan import KERNEL as SSD_KERNEL  # noqa: F401
from .ssd_scan import (ssd_chunk_intra, ssd_chunk_intra_bwd_heads,  # noqa
                       ssd_chunk_intra_heads)
from .ssd_state import STATE_BWD_KERNEL as SSD_STATE_BWD_KERNEL  # noqa: F401
from .ssd_state import STATE_KERNEL as SSD_STATE_KERNEL  # noqa: F401
from .ssd_state import ssd_state_bwd_heads, ssd_state_heads  # noqa: F401

KERNEL_OPS = (torch.ops.repro_torch.flash_attention,
              torch.ops.repro_torch.ssd_chunk_intra_heads,
              torch.ops.repro_torch.ssd_chunk_intra_bwd,
              torch.ops.repro_torch.ssd_state_fwd,
              torch.ops.repro_torch.ssd_state_bwd)
