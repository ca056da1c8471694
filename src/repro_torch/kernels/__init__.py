"""Hand-written Hopper kernels of the port, each with its plain version.

    flash_attention  csrc/flash_attention.cu  (replaces the Pallas
                     src/repro/kernels/flash_attention.py)

Kernels build with nvcc at first launch (`build.py`), never at import.
"""
from .flash_attention import KERNEL as FLASH_KERNEL  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .ops import flash_attention_bshd  # noqa: F401
from .ref import mha_reference  # noqa: F401
