"""Builds the port's CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` has a plain C interface: `nvcc` compiles it for
Hopper (`sm_90a`) into `build/<name>-<hash>.so` beside this file, where the
hash covers the source, the shared headers `csrc/*.cuh` and the flags, and
`ctypes` loads it.  Nothing includes PyTorch's headers, so a build takes
seconds (ssd_chunk.cu, forward and backward, about half a minute).  A
build runs at a kernel's first launch, never at import; `build(name,
force=True)` rebuilds.

`Kernel` binds one library's C entry point and counts its launches.  Every
entry point returns the CUDA error of its launch, and every source exports
`repro_cuda_error_string` to name it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

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


def through_op(*tensors) -> bool:
    """Whether a wrapper enters its custom op: under a dispatch mode (fake
    tensors, `analysis.hlo_count`'s counter) or for a tensor subclass,
    which must see the op (its fake implementation, its FLOP formula).  A
    plain call runs the op's body directly: the op's dispatch added ~44 us
    of host time to each flash call on an "NVIDIA H100 80GB HBM3, 700.00
    W" (chip_smoke.py phase 3's host_cost)."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    return _get_current_dispatch_mode() is not None or any(
        type(t) is not torch.Tensor for t in tensors)
