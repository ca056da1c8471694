"""Builds the port's CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` has a plain C interface: `nvcc` compiles it for
Hopper (`sm_90a`) into `build/<name>-<hash>.so` beside this file, where the
hash covers the source, the shared headers `csrc/*.cuh` and the flags, and
`ctypes` loads it.  Nothing includes PyTorch's headers, so a build takes
seconds (ssd_chunk.cu, forward and backward, about half a minute).  A
build runs at a kernel's first launch, never at import; `build(name,
force=True)` rebuilds.

`Kernel` binds one library's C entry point, launches it on a device's
current stream and counts its launches.  Every entry point returns the
CUDA error of its launch, and every source exports `repro_cuda_error_string`
to name it.  The wrappers' other shared plumbing is here too: dtype codes,
the bfloat16 loads' 16-byte row test, the way into a custom op.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# A library's own flags.  --split-compile=0: ptxas works on the kernels in
# parallel, one thread a CPU (ssd_chunk.cu's 98 kernels: 86 s in one
# thread, 31 s split over 8 cores; ssd_state.cu's 53 likewise); the other
# libraries build as before.
LIBRARY_FLAGS = {"ssd_chunk": ["--split-compile=0"],
                 "ssd_state": ["--split-compile=0"]}


# The dtype argument of every C entry point (float16: chunk_accum only).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# What the attention and SSD kernels take.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# The types of a plain call's arguments (`call`): any other, such as a
# tensor subclass, must see the custom op.
_PLAIN_ARGS = frozenset((torch.Tensor, int, float, bool, type(None)))


def nvcc_flags(name: str) -> list:
    return NVCC_FLAGS + LIBRARY_FLAGS.get(name, [])


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """build/<name>-<hash>.so, the hash over csrc/<name>.cu, every shared
    header csrc/*.cuh (a source may include any of them) and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(name: str, force: bool = False) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless its library is built already.
    Returns (library path, nvcc's log); raises with the log on failure."""
    out = library_path(name)
    if out.exists() and not force:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *nvcc_flags(name), "-o", tmp,
             str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    path, _ = build(name)
    return ctypes.CDLL(str(path))


class Kernel:
    """csrc/<name>.cu's C entry point `entry`, loaded at first launch, and
    `launches`, the number of successful launches."""

    def __init__(self, name: str, entry: str, argtypes: list):
        self.name = name
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, *args) -> None:
        """Call the entry point; raise on a CUDA error, else count."""
        lib = self.library()
        err = getattr(lib, self.entry)(*args)
        if err:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {err} "
                f"({lib.repro_cuda_error_string(err).decode()})")
        self.launches += 1

    def launch_on(self, device: torch.device, args: tuple) -> None:
        """`launch(*args)` on `device`'s current stream."""
        with torch.cuda.device(device):
            self.launch(*args, torch.cuda.current_stream(device).cuda_stream)


def rows_aligned(t: torch.Tensor, strides: tuple) -> bool:
    """The bfloat16 kernels' 16-byte loads: an aligned start, and (batch,
    head, seq) strides that keep every row aligned."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in strides)


def head_strides(t: torch.Tensor, h: int) -> tuple:
    """(batch, head, seq) strides of b or c [B,G,S,N] as the SSD kernels
    read them: a head stride of 0 when every head reads one b, c (G = 1)."""
    return t.stride(0), t.stride(1) if t.shape[1] == h else 0, t.stride(2)


def contiguous_block(t: torch.Tensor) -> bool:
    """The [P, N] blocks of SSD states contiguous and 16-byte aligned with
    their strides (the kernels read them in rows of 16 bytes)."""
    return (t.stride(-1) == 1 and t.stride(-2) == t.shape[-1]
            and t.data_ptr() % 16 == 0
            and all(st % 4 == 0 for st in t.stride()[:3]))


def mutating_op(name: str, body, mutates_args: tuple) -> None:
    """`body` as the custom op `name`, which writes `mutates_args` in place
    and returns nothing; so its fake implementation does nothing."""
    op = torch.library.custom_op(name, body, mutates_args=mutates_args)
    op.register_fake(lambda *args, **kwargs: None)


def copy_into(outs: tuple, values: tuple) -> None:
    """A wrapper's CPU branch: its plain version's values copied into the
    outputs it writes (None: an output this call does not have)."""
    for out, value in zip(outs, values):
        if out is not None:
            out.copy_(value)


def call(op, body, *args):
    """A wrapper's way into its kernel: `op(*args)`, the custom op, under a
    dispatch mode (fake tensors, `analysis.hlo_count`'s counter) or for a
    tensor subclass, which must see the op (its fake implementation, its
    FLOP formula); else `body(*args)`, the op's body, directly: the op's
    dispatch added ~44 us of host time to each flash call on an "NVIDIA
    H100 80GB HBM3, 700.00 W" (chip_smoke.py phase 3's host_cost)."""
    through = _get_current_dispatch_mode() is not None or any(
        type(t) not in _PLAIN_ARGS for t in args)
    return (op if through else body)(*args)
