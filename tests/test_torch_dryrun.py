"""The port's dry run (repro_torch.launch.dryrun) on fake meshes: cells of
every family at their published widths and 2 layers (zamba2 at 6, its
first shared-attention site) on the 16x16 and 2x16x16 meshes of a "fake"
process group, the reference's skips, the CLI's records and its exit code
on a failing cell, the argument bytes of a reduced train cell against the
reference's sharding specs and its JAX lowering, and the activation
policy's absence on the launchers' paths.  The fake tensors lie on the
CPU: a CPU-only PyTorch cannot index a fake CUDA tensor (the card's
machine runs --device cuda)."""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import reduced_config as jax_reduced
from repro.configs import skip_reason as jax_skip_reason
from repro.configs.shapes import shape_by_name as jax_shape
from repro.launch import sharding as jsh
from repro.models import build_model as jax_build
from repro.train import init_adamw
from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.fixture(autouse=True)
def no_process_group():
    """Each test starts and ends without a default process group: the fake
    one is global state."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# one arch of each family: one shape of each kind among them on 16x16, and
# a decode of each on 2x16x16 (a decode cell takes seconds; a prefill_32k
# cell ~25 s at 2 layers on the CPU, so one of attention is run); mamba2's
# train and long_500k, zamba2's prefill (the SSD op and flash's) and decode
ARCHS = ("qwen3-8b", "qwen2-moe-a2.7b", "paligemma-3b", "whisper-medium")
CELLS = [("qwen3-8b", "train_4k", False),
         ("qwen2-moe-a2.7b", "train_4k", False),
         ("paligemma-3b", "prefill_32k", False),
         ("whisper-medium", "decode_32k", False)] + \
    [(arch, "decode_32k", True) for arch in ARCHS] + \
    [("mamba2-780m", "train_4k", False), ("mamba2-780m", "long_500k", True),
     ("zamba2-1.2b", "prefill_32k", False),
     ("zamba2-1.2b", "decode_32k", True)]
# zamba2's shared block comes after every 6 Mamba2 layers: 2 would cut it
LAYERS = {"zamba2-1.2b": 6}


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_cell_counts_per_device(arch, shape, multi_pod):
    r = dryrun.lower_cell(arch, shape, multi_pod=multi_pod, device="cpu",
                          layers=LAYERS.get(arch, 2))
    assert r.ok and r.skip is None, r.error
    assert r.mesh == ("2x16x16" if multi_pod else "16x16")
    rf = r.roofline
    assert rf["chips"] == (512 if multi_pod else 256)
    assert np.isfinite(r.cost["flops"]) and r.cost["flops"] > 0
    assert np.isfinite(r.cost["bytes accessed"]) and \
        r.cost["bytes accessed"] > 0
    assert r.memory["argument_size_in_bytes"] > 0
    assert r.memory["total_per_device"] >= \
        r.memory["argument_size_in_bytes"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert set(r.collective_bytes) == set(KINDS)
    ops = r.collective_ops
    if shape == "train_4k":
        # FSDP: weights gathered over data, gradients reduce-scattered
        assert ops["all-gather"] > 0 and ops["reduce-scatter"] > 0
    else:
        # TP: a row-parallel product's partial sums are reduced (scattered
        # over the sequence where the residual policy splits it)
        assert ops["all-reduce"] + ops["reduce-scatter"] > 0
    # the dry run leaves no policy behind
    assert not tcommon._ACT_SHARDING and tmoe.get_moe_groups() == 1
    line = dryrun.format_line(r)
    assert line.startswith(f"OK   {arch}/{shape}/{r.mesh}")


def test_skips_give_the_reference_reasons():
    for arch in ("qwen3-8b", "whisper-medium", "gemma2-2b"):
        r = dryrun.lower_cell(arch, "long_500k", multi_pod=False,
                              device="cpu")
        assert r.ok and r.skip == jax_skip_reason(arch, jax_shape(
            "long_500k")) is not None
        assert dryrun.format_line(r).startswith(f"SKIP {arch}/long_500k")
    assert not dist.is_initialized()        # a skip builds no mesh


def test_cli_writes_records_and_exits_1_on_a_failure(tmp_path, capsys,
                                                     monkeypatch):
    """A cell whose step raises is recorded with its traceback, printed as
    FAIL, and the CLI exits 1."""
    def fail(*args, **kwargs):
        raise RuntimeError("injected failure of the step")
    monkeypatch.setattr(dryrun, "count_step", fail)
    rc = dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                      "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "mamba2-780m__long_500k__16x16.json")
                     .read_text())
    assert rec["ok"] is False and "injected failure" in rec["error"]
    out = capsys.readouterr().out
    assert "FAIL mamba2-780m/long_500k/16x16" in out
    assert "0/1 cells OK" in out


def test_device_cuda_needs_a_cuda_build(monkeypatch):
    monkeypatch.setattr(torch.version, "cuda", None)
    with pytest.raises(SystemExit, match="--device cpu"):
        dryrun.check_device("cuda")
    dryrun.check_device("cpu")


def test_constrain_is_the_identity_without_a_policy():
    """No policy is what both launchers run: constrain returns its input
    itself, a plain tensor or a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    assert not tcommon._ACT_SHARDING
    x = torch.ones(2, 4, 8)
    for kind in ("residual", "logits", "attn_qkv", "moe_tokens"):
        assert tcommon.constrain(x, kind) is x
    dryrun.fake_group(4)
    mesh = make_mesh(2, 2, "cpu")
    dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                            run_check=False)
    assert tcommon.constrain(dx, "residual") is dx
    with dryrun.activation_policy(mesh):
        # [B, S, d] with B and S divisible: batch over data, seq over model
        moved = tcommon.constrain(dx, "residual")
        assert [p.is_shard() for p in moved.placements] == [True, True]
        odd = DTensor.from_local(torch.ones(3, 4, 8), mesh,
                                 [Replicate(), Replicate()], run_check=False)
        assert tcommon.constrain(odd, "residual") is odd   # 3 rows: no fit
    assert tcommon.constrain(dx, "residual") is dx


# ---------------------------------------------------------------------- #
# argument bytes of a reduced train cell, against the reference
# ---------------------------------------------------------------------- #

SMALL = ShapeSpec("small_train", "train", 64, 4)


def _ref_local_bytes(tree, specs, sizes):
    """Sum over leaves of the local shard's bytes under a PartitionSpec."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = leaf.dtype.itemsize
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        for size, entry in zip(leaf.shape, spec):
            axes = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            n *= size // int(np.prod([sizes[a] for a in axes]))
        total += n
    return total


def _port_train_args(arch="qwen3-8b"):
    cfg = dataclasses.replace(reduced_config(arch), dtype=torch.bfloat16)
    dryrun.fake_group(4)
    counter, args = dryrun.count_step(cfg, SMALL, make_mesh(2, 2, "cpu"),
                                      "cpu")
    assert counter.flops > 0
    return args


def test_train_argument_bytes_equal_the_reference_specs():
    """bf16 params and f32 master, mu and nu, each rank's shard on a (2, 2)
    mesh: exactly the reference's param_specs / opt_specs leaf bytes on
    the same shapes (its step counter, one int32, aside)."""
    cfg = jax_reduced("qwen3-8b")
    params = jax.eval_shape(lambda: jax_build(cfg).init(
        jax.random.PRNGKey(0), jnp.bfloat16))
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((2, 2)))
    sizes = {"data": 2, "model": 2}
    p_spec = jsh.param_specs(params, mesh, fsdp=True)
    o_spec = jsh.opt_specs(p_spec, keep_master=True)
    opt = jax.eval_shape(lambda p: init_adamw(p, keep_master=True), params)
    got = _port_train_args()
    assert got["params"] == _ref_local_bytes(params, p_spec, sizes)
    for part in ("master", "mu", "nu"):
        assert got[part] == _ref_local_bytes(getattr(opt, part),
                                             getattr(o_spec, part), sizes)


_JAX_ARGS = r"""
import jax, jax.numpy as jnp, json, numpy as np, sys
from jax.sharding import Mesh
devices = jax.devices()   # 4 host devices, before the reference's dry run
                          # asks for 512
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import dryrun
from repro.models import build_model
cfg = reduced_config(sys.argv[1])
mesh = Mesh(np.array(devices).reshape(2, 2), ("data", "model"))
lowered = dryrun._lower_train(build_model(cfg, remat=True), cfg,
                              ShapeSpec("small_train", "train", 64, 4), mesh)
print(json.dumps(lowered.compile().memory_analysis().argument_size_in_bytes))
"""


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_train_argument_bytes_match_the_jax_lowering(arch):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_ARGS, arch], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    got = sum(_port_train_args(arch).values())
    assert abs(got - ref) <= 0.01 * ref, (got, ref)
