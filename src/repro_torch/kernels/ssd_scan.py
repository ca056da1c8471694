"""Mamba2 SSD intra-chunk block: the wrapper around the Hopper kernel.

The kernel, `csrc/ssd_chunk.cu`, replaces the Pallas TPU kernel
`_ssd_chunk_kernel` / `ssd_chunk_intra` in src/repro/kernels/ssd_scan.py;
its source says what bounds it on an H100 and how the design answers that.
Two entry points share it:

* `ssd_chunk_intra(x, dt, a, b, c, chunk)`: the Pallas kernel's layout,
  x [BH,S,P], dt [BH,S], a [BH], b, c [BH,S,N];
* `ssd_chunk_intra_heads(...)`: x [B,H,S,P] and b, c [B,G,S,N] with G = H
  or 1, read through their strides, so a transposed view of the model's
  [B,S,H,P] activations and b, c shared by every head are never copied;
  y and the states may be written into views given as `y` and `states`.

On CUDA tensors each launches the kernel (building it at first use) or
raises; on CPU tensors each computes its plain version in `ref.py`.
bfloat16 runs on the tensor cores (wgmma), float32 on the CUDA cores;
`launch_args` is the launch plan of both.  `KERNEL.launches` counts
launches.  There is no backward kernel, as the Pallas kernel has none:
inputs that require grad raise, so no gradient is silently lost; the
model's `ssd_chunked` takes the plain version under autograd on every
device instead, as `attend` does for attention.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .ref import ssd_chunk_intra_heads_reference

DIMS = (16, 32, 64, 128)        # head dims P and state dims N it takes
MAX_CHUNK = 4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# repro_ssd_chunk_fwd's C parameters: x, dt, a, b, c, y, states, work;
# dtype, batch, heads, seqlen, chunk, p, n; the strides of x, dt (b, h, s),
# a (b, h), b, c, y (b, h, s), states (b, h, chunk); stream
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 20
            + [ctypes.c_void_p])
TILE = 64                       # the kernel's rows per tile

KERNEL = build.Kernel("ssd_chunk", "repro_ssd_chunk_fwd", ARGTYPES)


def _check(x, dt, a, b, c, chunk) -> None:
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    if dt.shape != (bs, h, s) or a.shape != (bs, h):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if b.shape != c.shape or b.shape[0] != bs or b.shape[2] != s \
            or g not in (1, h):
        raise ValueError(f"b {tuple(b.shape)} / c {tuple(c.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    if not (x.dtype == b.dtype == c.dtype) or x.dtype not in _DTYPES:
        raise ValueError(f"x, b, c must share float32 or bfloat16, got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("x, dt, a, b, c must be on one device")
    if any(t.requires_grad for t in (x, dt, a, b, c)):
        raise ValueError("ssd_chunk_intra is a forward kernel with no "
                         "backward: inputs that require grad take the plain "
                         "path (repro_torch.models.ssm.ssd_chunked)")


def _head_strides(t: torch.Tensor, h: int) -> tuple:
    """(batch, head, seq) strides of b or c [B,G,S,N] as the kernel reads
    them: a head stride of 0 when every head reads one b, c (G = 1)."""
    return t.stride(0), t.stride(1) if t.shape[1] == h else 0, t.stride(2)


def _rows_aligned(t: torch.Tensor, strides: tuple) -> bool:
    """The bfloat16 kernel's 16-byte loads: an aligned start, and strides
    that keep every row aligned."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in strides)


def dense_if_unaligned(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, b, c of `ssd_chunk_intra_heads`, each copied to a dense tensor
    where its rows do not start on 16 bytes (what the bfloat16 kernel's
    loads need), else as given."""
    h = x.shape[1]
    return (x if _rows_aligned(x, x.stride()[:3]) else x.contiguous(),
            *(t if _rows_aligned(t, _head_strides(t, h)) else t.contiguous()
              for t in (b, c)))


def work_bytes(x: torch.Tensor, chunk: int) -> int:
    """Bytes of the bfloat16 kernel's work buffer for x [B,H,S,P]: cum
    (float64) and dt (float32) of every chunk, padded to whole tiles."""
    bs, h, s, _ = x.shape
    return 12 * -(-chunk // TILE) * TILE * bs * h * (s // chunk)


def launch_args(x, dt, a, b, c, y, states, work, chunk: int) -> tuple:
    """repro_ssd_chunk_fwd's arguments but the stream, for checked x, dt
    (float32), a (float32), b, c in `ssd_chunk_intra_heads`' layout, the
    outputs y and states, and `work` (uint8, `work_bytes`; None for
    float32); raises on what the kernel does not take.  Reads no device
    memory."""
    bs, h, s, p = x.shape
    n = b.shape[-1]
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"head dim {p} and state dim {n} must be in {DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("dt and a must be float32")
    bst, cst = _head_strides(b, h), _head_strides(c, h)
    if x.dtype == torch.bfloat16 and not all(
            _rows_aligned(t, st) for t, st in
            ((x, x.stride()[:3]), (b, bst), (c, cst), (y, y.stride()[:3]))):
        raise ValueError("bfloat16 rows of x, b, c and y must start on "
                         "16 bytes")
    if x.dtype == torch.bfloat16 and (
            work is None or work.numel() * work.element_size()
            < work_bytes(x, chunk) or work.data_ptr() % 16):
        raise ValueError(f"bfloat16 needs a 16-byte aligned work buffer of "
                         f"{work_bytes(x, chunk)} bytes")
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), states.data_ptr(),
            None if work is None else work.data_ptr(), _DTYPES[x.dtype],
            bs, h, s, chunk, p, n, *x.stride()[:3], *dt.stride(),
            *a.stride(), *bst, *cst, *y.stride()[:3], *states.stride()[:3])


def ssd_chunk_intra_heads(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor, chunk: int, *,
                          y: Optional[torch.Tensor] = None,
                          states: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,H,S,P]; dt: [B,H,S]; a: [B,H]; b, c: [B,G,S,N] with G = H or 1
    (every head reads the same b, c); any strides with the last dim
    contiguous, on every device (a stride of 0 broadcasts).  Returns (y
    [B,H,S,P] in x's dtype, states [B,H,S/chunk,P,N] float32), written into
    `y` and `states` when given (views of those shapes, last dims
    contiguous).  On the card, a bfloat16 x, b or c whose rows do not start
    on 16 bytes is copied to a dense tensor first, and such a `y` is
    written through one.  Under a dispatch mode (fake tensors, a counter)
    it runs through the custom op `repro_torch::ssd_chunk_intra_heads`; a
    plain call runs the op's body directly."""
    _check(x, dt, a, b, c, chunk)
    bs, h, s, p = x.shape
    n = b.shape[-1]
    shape_y, shape_st = (bs, h, s, p), (bs, h, s // chunk, p, n)
    for name, out, shape, dtype in (("y", y, shape_y, x.dtype),
                                    ("states", states, shape_st,
                                     torch.float32)):
        if out is not None and (out.shape != shape or out.dtype != dtype
                                or out.device != x.device):
            raise ValueError(f"{name} must be {dtype} {shape} on {x.device}, "
                             f"got {out.dtype} {tuple(out.shape)}")
    if any(t is not None and t.stride(-1) != 1 for t in (x, b, c, y, states)) \
            or (states is not None and states.stride(-2) != n):
        raise ValueError("the last dim of x, b, c, y and the [P, N] block of "
                         "states must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_chunk_intra runs on cuda or cpu, not {x.device}")
    if y is None:
        y = torch.empty(shape_y, dtype=x.dtype, device=x.device)
    if states is None:
        states = torch.empty(shape_st, dtype=torch.float32, device=x.device)
    args = (x, dt, a, b, c, chunk, y, states)
    if build.through_op(x, dt, a, b, c, y, states):
        torch.ops.repro_torch.ssd_chunk_intra_heads(*args)
    else:
        _ssd(*args)
    return y, states


def _ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, chunk: int, y: torch.Tensor,
         states: torch.Tensor) -> None:
    """The checked call, writing y and states."""
    if x.device.type == "cpu":
        ry, rs = ssd_chunk_intra_heads_reference(x, dt, a, b, c, chunk)
        y.copy_(ry)
        states.copy_(rs)
        return
    out_y = y
    if x.dtype == torch.bfloat16:
        x, b, c = dense_if_unaligned(x, b, c)
        if not _rows_aligned(y, y.stride()[:3]):
            y = torch.empty(y.shape, dtype=x.dtype, device=x.device)
    dt, a = dt.float(), a.float()       # [B,H,S] and [B,H]: cheap if copied
    work = torch.empty(work_bytes(x, chunk), dtype=torch.uint8,
                       device=x.device) if x.dtype == torch.bfloat16 else None
    args = launch_args(x, dt, a, b, c, y, states, work, chunk)
    with torch.cuda.device(x.device):
        KERNEL.launch(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if out_y is not y:
        out_y.copy_(y)


_ssd_op = torch.library.custom_op("repro_torch::ssd_chunk_intra_heads", _ssd,
                                  mutates_args=("y", "states"))


@_ssd_op.register_fake
def _(x, dt, a, b, c, chunk, y, states):
    return None


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_intra_heads)
def ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *args,
              out_shape=None, **kwargs) -> int:
    """The matmul FLOPs of the plain version, per chunk of Q rows: C.B^T
    once per group of b, c (2 Q Q N), and per head its masked product with
    x dt (2 Q Q P) and the state (2 P Q N):
    2 * B * S * (G Q N + H (Q P + P N))."""
    bs, h, s, p = x_shape
    g, n = b_shape[1], b_shape[-1]
    return 2 * bs * s * (g * chunk * n + h * (chunk * p + p * n))


def ssd_chunk_intra(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's layout: x [BH,S,P], dt [BH,S], a [BH], b, c
    [BH,S,N].  Returns (y_diag [BH,S,P] in x's dtype, states
    [BH,S/chunk,P,N] float32)."""
    if x.dim() != 3 or dt.dim() != 2 or a.dim() != 1 or b.dim() != 3 \
            or c.dim() != 3:
        raise ValueError("x, dt, a, b, c must be [BH,S,P], [BH,S], [BH], "
                         "[BH,S,N], [BH,S,N]")
    y, states = ssd_chunk_intra_heads(x[:, None], dt[:, None], a[:, None],
                                      b[:, None], c[:, None], chunk)
    return y[:, 0], states[:, 0]
