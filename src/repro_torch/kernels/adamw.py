"""AdamW's whole step on one hand-written multi-tensor kernel: the wrapper.

The kernel, `csrc/adamw.cu` (library `adamw`), replaces no Pallas kernel:
it does for plain CUDA float32 tensors what `train/optimizer.py`'s loop
does, bit for bit (its source gives the order of float32 operations), in
two launches for up to MAX_TENSORS tensors:

* `NORM_KERNEL`: the global norm of the gradients and the clip scale, into
  a float32 [2] tensor on the device (no host sync);
* `UPDATE_KERNEL`: the update of p, mu and nu in place, reading the scale
  from the device.

`step` runs both.  Each walks the chunk table (`chunk_table`: (tensor,
start, length), no chunk across two tensors), built with the tensor rows
(`tensor_row`: the pointers of p, mu and nu, the element count, the decay
flag) once per set of tensors (`Plan`, cached by those rows) and copied
to the device in one copy.  The gradients' pointers are new every step
and go in the launches' parameters.  The gradients are only read.

Every tensor must be a plain contiguous float32 tensor on one CUDA device;
anything else raises, naming the parameter.  CPU tensors, DTensors and
fake tensors take the loop: `train/optimizer.py` decides.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import build

CHUNK = 1 << 15          # elements a block updates
MAX_TENSORS = 1024       # csrc/adamw.cu: kMaxTensors, pointers in a launch

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# repro_adamw_norm's C parameters: chunks, n_chunks, grads, n, partials,
# done, out, clip, stream
NORM_ARGTYPES = [_P, _I64, _P, ctypes.c_int, _P, _P, _P, _F, _P]
# repro_adamw_update's: chunks, n_chunks, grads, n, rows, scale, b1, c1, b2,
# c2, inv_b1c, inv_b2c, eps, wd, lr, stream
UPDATE_ARGTYPES = [_P, _I64, _P, ctypes.c_int, _P, _P] + [_F] * 9 + [_P]

NORM_KERNEL = build.Kernel("adamw", "repro_adamw_norm", NORM_ARGTYPES)
UPDATE_KERNEL = build.Kernel("adamw", "repro_adamw_update", UPDATE_ARGTYPES)

# (name, param, grad, mu, nu)
Entry = Tuple[str, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_PLAIN = frozenset((torch.Tensor, nn.Parameter))


def chunk_table(numels: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(tensor, start, length) covering every element of every tensor
    once, tensor by tensor, each chunk at most CHUNK long and inside one
    tensor."""
    return [(t, s, min(CHUNK, n - s))
            for t, n in enumerate(numels) for s in range(0, n, CHUNK)]


def tensor_row(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor
               ) -> tuple:
    """(p, mu, nu pointers, numel, decay) of one tensor's row: decay 1
    exactly where p has 2 or more dimensions."""
    return (p.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
            int(p.dim() >= 2))


def constants(b1: float, b2: float, eps: float, weight_decay: float,
              lr: float, b1c: float, b2c: float) -> tuple:
    """The loop's scalars as its float32 tensors see them: each Python
    scalar rounded to float32, and a division by b1c or b2c as the
    multiply by the float32 reciprocal that PyTorch's CUDA division by a
    scalar runs.  (b1, c1, b2, c2, inv_b1c, inv_b2c, eps, wd, lr)."""
    f = np.float32
    return tuple(float(x) for x in (
        f(b1), f(1 - b1), f(b2), f(1 - b2), f(1) / f(b1c), f(1) / f(b2c),
        f(eps), f(weight_decay), f(lr)))


class Plan:
    """One set of tensors' device tables: the chunk table (int64 [n, 3]),
    the rows (int64 [t, 5]) and the norm's scratch (float64 partials, one
    a chunk, and the count of finished blocks, which the last block sets
    back to 0)."""

    def __init__(self, rows: Sequence[tuple], device: torch.device):
        if len(rows) > MAX_TENSORS:
            raise ValueError(f"adamw kernel: {len(rows)} tensors, more "
                             f"than the {MAX_TENSORS} a launch takes")
        table = chunk_table([r[3] for r in rows])
        if not table:
            raise ValueError("adamw kernel: no elements to update")
        self.numel = sum(r[3] for r in rows)
        self.chunks = torch.tensor(table, dtype=torch.int64).to(device)
        self.rows = torch.tensor(rows, dtype=torch.int64).to(device)
        self.partials = torch.empty(len(table), dtype=torch.float64,
                                    device=device)
        self.done = torch.zeros(1, dtype=torch.int32, device=device)


_PLANS: Dict[tuple, Plan] = {}
_PLANS_KEPT = 4


def _refuse(name: str, role: str, t, shape, device) -> None:
    raise ValueError(
        f"adamw kernel: the {role} of {name!r} must be a plain contiguous "
        f"float32 tensor of {tuple(shape)} on {device}, got "
        f"{type(t).__name__} {t.dtype} {tuple(t.shape)} on {t.device}")


def _fits(t, shape, device) -> bool:
    return (type(t) in _PLAIN and t.dtype is torch.float32
            and t.device == device and t.is_contiguous() and t.shape == shape)


def _prepare(entries: Sequence[Entry]) -> tuple:
    """(Plan, device, the gradients' pointers) of the entries.  The Plan is
    built at the first use of their rows (a key holds every value of the
    tables, so a hit is the same tables).  The gradients, new every step,
    are checked at every call; params and moments in full when a Plan is
    built, and their dtype and layout at every call too, since a freed
    tensor's address and size may come back as another tensor's.  The key
    is made anew at every call because the caller may replace a tensor
    between calls (a restore, a rebuilt state)."""
    device = entries[0][1].device
    if device.type != "cuda":
        raise ValueError(f"adamw kernel: tensors on {device}, not cuda")
    rows, grads, plain = [], [], True
    f32 = torch.float32
    for name, p, g, mu, nu in entries:
        shape = p.shape
        if not _fits(g, shape, device):
            _refuse(name, "grad", g, shape, device)
        plain = plain and p.dtype is mu.dtype is nu.dtype is f32 and \
            p.is_contiguous() and mu.is_contiguous() and nu.is_contiguous()
        rows.append(tensor_row(p, mu, nu))
        grads.append(g.data_ptr())
    key = (device, tuple(rows))
    plan = _PLANS.get(key)
    if plan is None or not plain:
        for name, p, _, mu, nu in entries:
            for role, t in (("param", p), ("mu", mu), ("nu", nu)):
                if not _fits(t, p.shape, device):
                    _refuse(name, role, t, p.shape, device)
        if len(_PLANS) >= _PLANS_KEPT:
            _PLANS.pop(next(iter(_PLANS)))
        plan = _PLANS[key] = Plan(rows, device)
    return plan, device, (_P * len(grads))(*grads)


def step(entries: Sequence[Entry], grad_clip: float, consts: tuple
         ) -> Tuple[torch.Tensor, int]:
    """The gradients' global norm (summed in float64) and scale =
    min(1, grad_clip / (norm + 1e-9)) into a float32 [2] tensor on the
    device, then p, mu and nu of every entry updated in place from its
    gradient times that scale; `consts` from `constants`.  Returns (the
    [2] tensor, the elements updated).  Two launches; the gradients'
    values are left as they were."""
    plan, device, grads = _prepare(entries)
    n, chunks = len(entries), plan.chunks.shape[0]
    out = torch.empty(2, dtype=torch.float32, device=device)
    NORM_KERNEL.launch_on(device, (
        plan.chunks.data_ptr(), chunks, grads, n, plan.partials.data_ptr(),
        plan.done.data_ptr(), out.data_ptr(), grad_clip))
    UPDATE_KERNEL.launch_on(device, (
        plan.chunks.data_ptr(), chunks, grads, n, plan.rows.data_ptr(),
        out.data_ptr() + 4, *consts))
    return out, plan.numel
