"""Per-device collective bytes of the port's dry run (DTensor under a
"fake" process group) against the reference's JAX lowering (GSPMD on 4
forced host devices) of the same cell: reduced configs, their widths as
the registry gives them, small batch and sequence shapes that divide the
mesh the way the full cells do.

* qwen3-8b train on (data, model) = (2, 2): FSDP+TP, whose weights the
  port gathers over "data" before each product (`models.common.unshard`)
  instead of gathering the activations;
* qwen3-8b and gemma2-2b decode on (1, 4): 2 kv heads do not divide
  "model", so the cache lies split on head_dim and decode contracts each
  rank's slice (`attention._attend_head_dim`), the cache never gathered;
* mamba2-780m train on (2, 2).

Each cell asserts the port's total collective wire bytes a device (the
reference's ring model, `_collective_wire_bytes`, on both sides) at most
RATIO times the reference's, and prints both by kind (`pytest -s`).  The
reference's lowering runs in its own subprocess, one per cell, started
together."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RATIO = 1.25
# (arch, kind, seq, batch, data, model)
CELLS = [("qwen3-8b", "train", 64, 4, 2, 2),
         ("qwen3-8b", "decode", 64, 4, 1, 4),
         ("gemma2-2b", "decode", 64, 4, 1, 4),
         ("mamba2-780m", "train", 64, 4, 2, 2)]

_JAX_BYTES = r"""
import jax, json, numpy as np, sys
from jax.sharding import Mesh
devices = jax.devices()   # 4 host devices, before the reference's dry run
                          # asks for 512
from repro.analysis import hlo_count
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import dryrun
from repro.models import build_model
arch, kind, seq, batch, dp, mp = sys.argv[1:]
cfg = reduced_config(arch)
mesh = Mesh(np.array(devices).reshape(int(dp), int(mp)), ("data", "model"))
lower = {"train": dryrun._lower_train, "decode": dryrun._lower_decode}[kind]
lowered = lower(build_model(cfg, remat=True), cfg,
                ShapeSpec("small", kind, int(seq), int(batch)), mesh)
c = hlo_count.count(lowered.compile().as_text())
print(json.dumps({"bytes": c["collective_bytes"],
                  "ops": c["collective_ops"]}))
"""


@pytest.fixture(scope="module")
def reference():
    """{cell: the reference's {'bytes', 'ops'} by kind}, its lowerings run
    in parallel subprocesses."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {cell: subprocess.Popen(
        [sys.executable, "-c", _JAX_BYTES, *map(str, cell)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell in CELLS}
    out = {}
    for cell, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2000:]
        out[cell] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.fixture(autouse=True)
def no_process_group():
    """The fake process group is global state: none before, none after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _port(arch, kind, seq, batch, dp, mp):
    cfg = dataclasses.replace(reduced_config(arch), dtype=torch.bfloat16)
    dryrun.fake_group(dp * mp)
    counter, _ = dryrun.count_step(cfg, ShapeSpec("small", kind, seq, batch),
                                   make_mesh(dp, mp, "cpu"), "cpu")
    return counter


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{c[4]}x{c[5]}")
def test_collective_bytes_within_the_reference(cell, reference):
    arch, kind, seq, batch, dp, mp = cell
    counter = _port(*cell)
    got = counter.totals()
    ref = reference[cell]
    total, ref_total = (sum(d.values()) for d in (
        got["collective_bytes"], ref["bytes"]))
    print(f"\n{arch} {kind} ({dp}, {mp}): port {total} B "
          f"{got['collective_bytes']} ops {got['collective_ops']}; "
          f"reference {ref_total} B {ref['bytes']} ops {ref['ops']}; "
          f"ratio {total / ref_total:.3f}")
    assert ref_total > 0 and total > 0
    assert total <= RATIO * ref_total, (total, ref_total)
    if kind == "decode":
        # no rank gathers its head_dim slice of a cache [B, T, Hkv, D / mp]
        cfg = reduced_config(arch)
        cache = f"[{batch}, {seq}, {cfg.num_kv_heads}, {cfg.hd // mp}]"
        gathers = [line for _, _, k, line in counter.records
                   if k == "COLL:all-gather" and cache in line.split("->")[0]]
        assert not gathers, gathers
