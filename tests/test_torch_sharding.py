"""The port's sharding policy (repro_torch.launch.sharding) against the
reference's (src/repro/launch/sharding.py), spec for spec, with no process
group: every config of the registry at full size (the reference's params
from `jax.eval_shape`, the port's module on the meta device), on the
production meshes and small ones.  The reference is given a stand-in
mesh with `axis_names` and a `devices` array, which is all its spec
functions read.

The comparison maps names and layouts: the reference stacks layers
[L, ...] (its specs then lead with None for the layer dim), the port
splits them into `layers.{i}`; every port leaf that is an `nn.Linear` is
stored [out, in], so its spec is the reference's with dims 0 and 1
swapped.  Equality is exact."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.launch import sharding as jsh
from repro.launch.sharding import tree_path_str
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import _MODULES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import build_model

torch.set_num_threads(1)

MESHES = [(16, 16), (2, 16, 16), (2, 2), (1, 4), (4, 1), (1, 8)]
ARCH_NAMES = sorted(ARCHS)


def ref_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                               "model")
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def axis_sizes(shape):
    return tmesh.mesh_axis_sizes(ref_mesh(shape))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = jax_config(arch)
    return jax.eval_shape(
        lambda: jax_build(cfg).init(jax.random.PRNGKey(0), jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def port_module(arch):
    cfg = get_config(arch)
    with torch.device("meta"):
        return _MODULES[cfg.family](cfg, torch.bfloat16)


def flat_specs(tree):
    return {tree_path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def port_view(ref_spec, name, ndim, linear):
    """The reference's spec of a port leaf: the layer dim dropped, padded
    to the leaf's dims, dims 0 and 1 swapped for an nn.Linear."""
    stacked = any(part.isdigit() for part in name.split("."))
    spec = list(padded(ref_spec, ndim + stacked))[stacked:]
    if linear:
        spec[0], spec[1] = spec[1], spec[0]
    return tuple(spec)


def expected_param_specs(arch, shape, fsdp):
    ref = flat_specs(jsh.param_specs(ref_params(arch), ref_mesh(shape),
                                     fsdp=fsdp))
    return {name: port_view(ref[path], name, p.dim(), linear)
            for name, p, path, linear in tsh._leaves(port_module(arch))}


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, shape):
    module = port_module(arch)
    assert tsh.param_specs(module, axis_sizes(shape), fsdp=True) == \
        expected_param_specs(arch, shape, True)
    assert tsh.serving_param_specs(module, axis_sizes(shape)) == \
        expected_param_specs(arch, shape, False)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_specs_equal_the_reference(arch, shape):
    """mu, nu (and the master copy, where kept) mirror the param specs;
    step is replicated."""
    mesh = ref_mesh(shape)
    p_ref = jsh.param_specs(ref_params(arch), mesh)
    p_port = tsh.param_specs(port_module(arch), axis_sizes(shape))
    want = expected_param_specs(arch, shape, True)
    for keep in (False, True):
        ref = jsh.opt_specs(p_ref, keep_master=keep)
        got = tsh.opt_specs(p_port, keep_master=keep)
        assert tuple(ref.step) == got["step"] == ()
        assert got["mu"] == got["nu"] == want
        assert (got["master"] == want) if keep else got["master"] is None
        assert (ref.master is not None) == keep


def batch_shapes(b):
    return {"tokens": (b, 64), "loss_mask": (b, 64),
            "patch_embed": (b, 256, 2048), "audio_embed": (b, 1500, 1024)}


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("b", [2, 6, 16, 512])
def test_batch_specs_equal_the_reference(b, shape):
    shapes = batch_shapes(b)
    ref = jsh.batch_specs({k: jax.ShapeDtypeStruct(s, jnp.float32)
                           for k, s in shapes.items()}, ref_mesh(shape))
    got = tsh.batch_specs({k: torch.empty(s, device="meta")
                           for k, s in shapes.items()}, axis_sizes(shape))
    assert got == {k: padded(ref[k], len(s)) for k, s in shapes.items()}


def tensor_leaves(tree, prefix=""):
    """{path: tensor} of a state of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(tensor_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def spec_at(specs, path):
    for key in path.split("/"):
        specs = specs[key] if isinstance(specs, dict) else specs[int(key)]
    return specs


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_state_specs_equal_the_reference(arch, shape):
    """Each family's decode state (KV caches, SSM and conv states, the
    encoder output) at batch 4 and 2048 positions."""
    cfg_j, cfg_t = jax_config(arch), get_config(arch)
    ref_state = jax.eval_shape(
        lambda: jax_build(cfg_j).init_decode_state(4, 2048))
    ref = flat_specs(jsh.decode_state_specs(ref_state, cfg_j,
                                            ref_mesh(shape)))
    state = build_model(cfg_t).init_decode_state(4, 2048, torch.bfloat16,
                                                 "meta")
    specs = tsh.decode_state_specs(state, cfg_t, axis_sizes(shape))
    leaves = tensor_leaves(state)
    assert set(leaves) == set(ref)
    for k, leaf in leaves.items():
        assert spec_at(specs, k) == padded(ref[k], leaf.dim()), k


def test_per_rank_bytes_of_mixtral_at_tp4():
    """Serving's per-rank bytes for mixtral-8x7b at TP 4 from the meta
    module: the expert tensors split their ff dim four ways."""
    cfg = get_config("mixtral-8x7b")
    module, sizes = port_module("mixtral-8x7b"), {"data": 1, "model": 4}
    specs = tsh.serving_param_specs(module, sizes)
    total = sum(p.numel() * 2 for p in module.parameters())
    local = sum(tsh.local_bytes(p.shape, specs[n], sizes, 2)
                for n, p in module.named_parameters())
    experts = sum(p.numel() for n, p in module.named_parameters()
                  if ".moe.w_" in n)
    assert experts == cfg.num_layers * 3 * cfg.num_experts * \
        cfg.d_model * cfg.moe_d_ff
    assert total / 4 <= local < total / 4 * 1.01
