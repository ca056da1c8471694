"""Chunk accumulate: the wrapper around the Hopper kernel.

The kernel, `csrc/chunk_accum.cu`, replaces the Pallas TPU kernel
`_accum_kernel` / `chunk_accum` in src/repro/kernels/chunk_accum.py; its
source says what bounds it on an H100 and how the design answers that.  It
adds a float32, bfloat16 or float16 update into a float32 accumulator in
place, in two forms:

* `chunk_accum(acc, update)`: acc += update, the Pallas kernel's function;
* `chunk_accum_indexed(acc, idx, update, skip)`: acc[idx[j]] += update[j]
  for every j with idx[j] != skip — the scatter-add of a reduce-scatter
  round, where `skip` is the program's trash row.

On CUDA tensors each launches the kernel (building it at first use) or
raises; on CPU tensors each computes its plain version in `ref.py`.
`KERNEL.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import chunk_accum_indexed_reference, chunk_accum_reference

# repro_chunk_accum's C parameters: acc, update, dtype, idx, rows, cols,
# skip, stream
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]

KERNEL = build.Kernel("chunk_accum", "repro_chunk_accum", ARGTYPES)


def _check(acc: torch.Tensor, update: torch.Tensor) -> None:
    if acc.dim() != 2 or update.dim() != 2 or acc.shape[1] != update.shape[1]:
        raise ValueError(f"acc {tuple(acc.shape)} and update "
                         f"{tuple(update.shape)} must be [*, C] with one C")
    if acc.dtype != torch.float32:
        raise ValueError(f"acc must be float32, got {acc.dtype}")
    if update.dtype not in build.DTYPE_CODES:
        raise ValueError(f"update must be float32, bfloat16 or float16, got "
                         f"{update.dtype}")
    if acc.device != update.device:
        raise ValueError("acc and update must be on one device")
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chunk_accum runs on cuda or cpu, not {acc.device}")


def _launch(acc: torch.Tensor, update: torch.Tensor, idx_ptr: int,
            skip: int) -> None:
    if not (acc.is_contiguous() and update.is_contiguous()):
        raise ValueError("acc and update must be contiguous")
    if update.numel() == 0:
        return
    KERNEL.launch_on(acc.device, (
        acc.data_ptr(), update.data_ptr(), build.DTYPE_CODES[update.dtype],
        idx_ptr, update.shape[0], update.shape[1], skip))


def chunk_accum(acc: torch.Tensor, update: torch.Tensor) -> torch.Tensor:
    """acc: [N, C] float32; update: [N, C] float32/bfloat16/float16.
    acc += update in float32, in place; returns acc."""
    _check(acc, update)
    if acc.shape != update.shape:
        raise ValueError(f"acc {tuple(acc.shape)} != update "
                         f"{tuple(update.shape)}")
    if acc.device.type == "cpu":
        return chunk_accum_reference(acc, update)
    _launch(acc, update, 0, -1)
    return acc


def chunk_accum_indexed(acc: torch.Tensor, idx: torch.Tensor,
                        update: torch.Tensor, skip: int) -> torch.Tensor:
    """acc: [M, C] float32; idx: [W] int64 rows of acc; update: [W, C].
    acc[idx[j]] += update[j] in float32 for every j with idx[j] != skip, in
    place; returns acc.  Any row other than `skip` may appear at most once
    in idx (the kernel adds rows in parallel); `skip` any number of times.
    Indices are not range-checked on the card."""
    _check(acc, update)
    if idx.dtype != torch.int64 or idx.shape != update.shape[:1]:
        raise ValueError(f"idx must be int64 [{update.shape[0]}], got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != acc.device:
        raise ValueError("idx must be on acc's device")
    if acc.device.type == "cpu":
        return chunk_accum_indexed_reference(acc, idx, update, skip)
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    _launch(acc, update, idx.data_ptr(), skip)
    return acc
