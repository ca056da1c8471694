"""The port's flash attention against the JAX reference, on the CPU.

On CPU tensors the port's wrapper computes its plain version
(repro_torch.kernels.ref.mha_reference); it is held here against the Pallas
kernel in interpret mode and the reference's mha_reference over the sweeps of
tests/test_kernels.py, and against mha_reference alone for ragged lengths,
which the Pallas kernel refuses.  The CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py.
"""
import ctypes
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import mha_reference as jax_mha
from repro_torch.kernels import (FLASH_KERNEL, build, flash_attention,
                                 mha_reference)
from repro_torch.kernels.flash_attention import (ARGTYPES, HEAD_DIMS,
                                                  launch_args)
from repro_torch.kernels.ops import flash_attention_bshd
from repro_torch.models.attention import MaskSpec

torch.set_num_threads(1)

# f32: a different summation order; bf16: the output's rounding
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def qkv(b, h, hkv, sq, skv, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32), np.float32)


def check(got, *refs, dtype):
    for ref in refs:
        np.testing.assert_allclose(as_np(got), as_np(ref), atol=ATOL[dtype])


@pytest.mark.parametrize("shape", [
    (1, 2, 2, 128, 16),    # MHA
    (2, 4, 2, 256, 32),    # GQA
    (1, 4, 1, 128, 64),    # MQA
    (2, 2, 2, 512, 16),    # longer seq
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_shapes_dtypes(shape, dtype):
    b, h, hkv, s, d = shape
    (jq, jk, jv), (tq, tk, tv) = qkv(b, h, hkv, s, s, d, dtype)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    check(got, jax_flash(jq, jk, jv, block_q=64, block_kv=64, interpret=True),
          jax_mha(jq, jk, jv), dtype=dtype)


MASKS = [
    dict(causal=False),
    dict(causal=True, window=64),
    dict(causal=True, prefix_len=32),
    dict(causal=True, logit_cap=50.0),
    dict(causal=True, window=96, logit_cap=30.0),
]


@pytest.mark.parametrize("kwargs", MASKS)
def test_flash_plain_matches_jax_mask_variants(kwargs):
    (jq, jk, jv), (tq, tk, tv) = qkv(2, 4, 2, 256, 256, 32, "float32")
    got = flash_attention(tq, tk, tv, **kwargs)
    check(got, jax_flash(jq, jk, jv, block_q=64, block_kv=64, interpret=True,
                         **kwargs),
          jax_mha(jq, jk, jv, **kwargs), dtype="float32")


@pytest.mark.parametrize("sq,skv", [(77, 77), (1000, 1000), (200, 77),
                                    (77, 200)])
@pytest.mark.parametrize("kwargs", [dict(causal=True)] + MASKS)
def test_flash_plain_ragged_lengths(sq, skv, kwargs):
    """Lengths no block size divides; (200, 77) with a window leaves rows
    with no allowed column, which average v over all columns."""
    (jq, jk, jv), (tq, tk, tv) = qkv(1, 4, 2, sq, skv, 16, "float32")
    check(flash_attention(tq, tk, tv, **kwargs), jax_mha(jq, jk, jv, **kwargs),
          dtype="float32")


def test_wrapper_on_cpu_takes_plain_path_without_launch():
    _, (tq, tk, tv) = qkv(1, 4, 2, 64, 64, 32, "float32")
    before = FLASH_KERNEL.launches
    flash_attention(tq, tk, tv)
    assert FLASH_KERNEL.launches == before
    assert FLASH_KERNEL._lib is None          # nothing was built or loaded


def test_wrapper_refuses_other_devices_and_bad_arguments():
    _, (tq, tk, tv) = qkv(1, 4, 2, 64, 64, 32, "float32")
    meta = [t.to("meta") for t in (tq, tk, tv)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(*meta)
    with pytest.raises(ValueError, match="window"):
        flash_attention(tq, tk, tv, window=0)
    three = [torch.cat([t, t[:, :1]], dim=1) for t in (tk, tv)]
    with pytest.raises(ValueError, match="group"):
        flash_attention(tq, *three)             # 4 query heads, 3 kv heads
    with pytest.raises(ValueError, match="share"):
        flash_attention(tq, tk.double(), tv)


def test_bshd_adapter_matches_bhsd():
    (jq, jk, jv), (tq, tk, tv) = qkv(2, 4, 2, 96, 96, 16, "float32")
    spec = MaskSpec(causal=True, window=40)
    got = flash_attention_bshd(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), spec, 30.0)
    ref = jax_mha(jq, jk, jv, causal=True, window=40, logit_cap=30.0)
    check(got.transpose(1, 2), ref, dtype="float32")


def test_ctypes_signature_matches_the_c_entry_point():
    """The kernel builds only on the card, so the binding's argument list is
    held here against the C prototype in the source."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    params = re.search(r"int repro_flash_attention_fwd\((.*?)\)", src,
                       re.S).group(1)
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "int64_t": ctypes.c_int64, "float": ctypes.c_float}
    declared = [c_types[re.sub(r"^const ", "", p.strip()).rsplit(" ", 1)[0]
                        .replace(" *", "*")]
                for p in params.split(",")]
    assert declared == ARGTYPES


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_plan_takes_every_head_dim(d, dtype):
    """The launch plan (what a CUDA call hands the C entry point) accepts
    every head dim the kernel is built for, in both dtypes, through the
    model's strided [B,S,H,D] views."""
    _, (tq, tk, tv) = qkv(2, 4, 2, 33, 40, d, dtype)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (tq, tk, tv))
    out = torch.empty_like(q)
    args = launch_args(q, k, v, out, causal=True, window=8, prefix_len=3,
                       logit_cap=30.0)
    assert len(args) == len(ARGTYPES) - 1          # all but the stream
    assert args[4:11] == ({"float32": 0, "bfloat16": 1}[dtype],
                          2, 4, 2, 33, 40, d)
    assert args[11:14] == q.stride()[:3] and args[20:23] == out.stride()[:3]
    assert args[23:] == (1, 8, 3, 30.0)


def test_launch_plan_refuses_what_the_kernel_does_not_take():
    _, (tq, tk, tv) = qkv(1, 4, 2, 16, 16, 48, "bfloat16")
    with pytest.raises(ValueError, match="head dim 48"):
        launch_args(tq, tk, tv, torch.empty_like(tq), causal=True,
                    window=None, prefix_len=0, logit_cap=None)
    _, (tq, tk, tv) = qkv(1, 4, 2, 16, 16, 72, "bfloat16")
    q = tq[..., 8:]                  # rows start 16 bytes in: aligned
    launch_args(q, tk[..., 8:], tv[..., 8:], torch.empty_like(q),
                causal=True, window=None, prefix_len=0, logit_cap=None)
    q = tq[..., 1:65]                # bf16 rows 2 bytes off 16
    with pytest.raises(ValueError, match="16 bytes"):
        launch_args(q, tk[..., :64], tv[..., :64], torch.empty_like(q),
                    causal=True, window=None, prefix_len=0, logit_cap=None)
    # float32 takes any start; the CPU path takes the plain version
    launch_args(q.float(), tk[..., :64].float(), tv[..., :64].float(),
                torch.empty_like(q.float()), causal=True, window=None,
                prefix_len=0, logit_cap=None)
    check(flash_attention(q, tk[..., :64], tv[..., :64]),
          mha_reference(q, tk[..., :64], tv[..., :64]), dtype="bfloat16")


def test_library_path_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to any csrc/*.cuh names a new library, so it is rebuilt."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    changed = build.library_path("k")
    assert changed != before
    (tmp_path / "h.cuh").write_text("// one\n")
    assert build.library_path("k") == before
    (tmp_path / "g.cuh").write_text("")
    assert build.library_path("k") not in (before, changed)
    assert build.library_path("k").parent == build.BUILD_DIR


def test_split_compile_is_the_ssd_librarys_own_flag():
    """ssd_chunk.cu alone builds with ptxas split over the CPUs: the other
    libraries keep the common flags, so their code and names stay."""
    assert "--split-compile=0" in build.nvcc_flags("ssd_chunk")
    for name in ("flash_attention", "chunk_accum"):
        assert build.nvcc_flags(name) == build.NVCC_FLAGS


def test_chip_smoke_refuses_to_run_without_a_card():
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
