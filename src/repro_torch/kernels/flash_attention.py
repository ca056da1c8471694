"""Flash attention forward: the wrapper around the Hopper kernel.

The kernel, `csrc/flash_attention.cu`, replaces the Pallas TPU kernel
`_flash_kernel` in src/repro/kernels/flash_attention.py; its source says what
bounds it on an H100 and how the design answers that.  Unlike the Pallas
kernel it takes any Sq and Skv: ragged tails are masked inside the kernel.

`flash_attention` on CUDA tensors launches the kernel (building it at first
use) or raises; on CPU tensors it computes the plain version,
`ref.mha_reference`.  bfloat16 runs on the tensor cores (wgmma), float32 on
the CUDA cores; `launch_args` is the launch plan of both.  `KERNEL.launches`
counts launches.  There is no backward kernel, as the Pallas kernel has
none: inputs that require grad raise, so no gradient is silently lost.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .ref import mha_reference

HEAD_DIMS = (16, 32, 64, 128, 256)
# repro_flash_attention_fwd's C parameters: q, k, v, o; dtype, b, h, hkv,
# sq, skv, d; the strides (b, h, s) of q, k, v, o; causal, window,
# prefix_len; logit_cap; stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])


KERNEL = build.Kernel("flash_attention", "repro_flash_attention_fwd", ARGTYPES)


def _check(q, k, v, window, prefix_len, logit_cap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B,H,S,D]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    hkv = k.shape[1]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in build.COMPUTE_DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention is a forward kernel with no "
                         "backward: inputs that require grad take the plain "
                         "path (repro_torch.models.attention.attend)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be > 0, got {logit_cap}")


def launch_args(q, k, v, out, *, causal: bool, window: Optional[int],
                prefix_len: int, logit_cap: Optional[float]) -> tuple:
    """repro_flash_attention_fwd's arguments but the stream, for checked
    q, k, v and `out` (q's shape and dtype); raises on what the kernel does
    not take.  Reads no device memory."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v, out)):
        raise ValueError("the head dim of q, k, v must be contiguous")
    if q.numel() == 0 or skv == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype == torch.bfloat16 and not all(
            build.rows_aligned(t, t.stride()[:3]) for t in (q, k, v, out)):
        raise ValueError("bfloat16 rows of q, k, v and out must start on "
                         "16 bytes")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            build.DTYPE_CODES[q.dtype], b, h, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            int(causal), window or 0, prefix_len, logit_cap or 0.0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0,
                    logit_cap: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k, v: [B,Hkv,Skv,D] -> [B,H,Sq,D] in q's dtype.
    The output has q's strides, so a transposed view of a [B,S,H,D] tensor
    gives an output whose transpose is contiguous.  A bfloat16 view whose
    rows do not start on 16 bytes is copied to a dense one first.  Under a
    dispatch mode (fake tensors, a counter) it runs through the custom op
    `repro_torch::flash_attention`, so they see its fake implementation
    and FLOP formula; a plain call runs the op's body directly."""
    _check(q, k, v, window, prefix_len, logit_cap)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return build.call(torch.ops.repro_torch.flash_attention, _flash, q, k, v,
                      causal, window or 0, prefix_len, logit_cap or 0.0)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int, prefix_len: int,
           logit_cap: float) -> torch.Tensor:
    """The checked call: window 0 and logit_cap 0.0 mean none."""
    window, logit_cap = window or None, logit_cap or None
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len, logit_cap=logit_cap)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if build.rows_aligned(t, t.stride()[:3]) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    out = torch.empty_like(q)
    args = launch_args(q, k, v, out, causal=causal, window=window,
                       prefix_len=prefix_len, logit_cap=logit_cap)
    KERNEL.launch_on(q.device, args)
    return out


_flash_op = torch.library.custom_op("repro_torch::flash_attention",
                                    _flash, mutates_args=())


@_flash_op.register_fake
def _(q, k, v, causal, window, prefix_len, logit_cap):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs
                ) -> int:
    """The matmul FLOPs of the plain version: q.k and p.v over every
    (query, key) pair, 4 * B * H * Sq * Skv * D, whatever the mask."""
    b, h, sq, d = q_shape
    return 4 * b * h * sq * k_shape[2] * d
