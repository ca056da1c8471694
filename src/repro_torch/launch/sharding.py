"""Sharding policy: specs for params, optimizer state, batch and decode
state, per architecture and mesh, and their DTensor placements.
Counterpart of src/repro/launch/sharding.py, with its rules and its order.

Training is FSDP+TP ("zero3"): every large matrix is sharded over BOTH the
data axis (FSDP) and the model axis (TP).  Serving is TP only (params
replicated over data, so decode batches scale).

Two layers:

* spec functions (`param_specs`, `serving_param_specs`, `opt_specs`,
  `batch_specs`, `decode_state_specs`) take a module or tensors (the meta
  device will do) and the mesh's axis sizes, and give each leaf a tuple
  with one entry per tensor dim: an axis name, a tuple of axis names, or
  None.  That is the content of the reference's PartitionSpec.  They need
  no process group.
* placements (`to_placements`, `distribute_module`, `distribute_tree`)
  turn a spec into one `Shard(d)` or `Replicate()` per mesh dim and place
  tensors as DTensors on a `DeviceMesh`.

The port's names and layouts differ from the reference's, and the rules
are applied to the port's: its stacked [L, ...] layers are split into
`layers.{i}.<path>`, so no dim is offset by a layer dim; and every leaf
that is an `nn.Linear` (the attention and MLP projections, the shared
expert's, Mamba2's in_proj and out_proj, the untied lm_head) is stored
[out, in], so a rule's dims 0 and 1 are swapped for it.  The embedding
[V, d], the MoE expert tensors [E, d, ff] / [E, ff, d], the router [d, E]
and the conv taps [W, C] keep the reference's layout.  Every assignment is
checked for divisibility, with fallbacks (whisper's 51865 vocab, 8 kv heads
of a cache on a 16-way model axis).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Sequence, Tuple

import torch
from torch import nn

Spec = Tuple[Any, ...]
AxisSizes = Dict[str, int]


def _fits(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _assign(shape: Sequence[int], prefs: Sequence[Tuple[int, str]],
            axis_sizes: AxisSizes) -> Spec:
    """Greedy: for each (dim, axis) preference, take it if divisible and
    neither dim nor axis is already used."""
    spec: list = [None] * len(shape)
    used_axes = set()
    for dim, axis in prefs:
        if dim >= len(shape) or spec[dim] is not None or axis in used_axes:
            continue
        if axis in axis_sizes and _fits(shape[dim], axis_sizes[axis]):
            spec[dim] = axis
            used_axes.add(axis)
    return tuple(spec)


# param-name patterns -> sharding preferences, as (regex, [(dim, axis)...]),
# dims in the reference's layout; matched against the port's name with its
# layer indices dropped and "/" for "."
_PARAM_RULES = [
    # moe experts [E, d, ff] / [E, ff, d] MUST precede the generic matmul
    # rules: TP on the per-expert ff dim, FSDP on d
    (r"moe/w_(gate|up)$", [(2, "model"), (1, "data")]),
    (r"moe/w_down$", [(1, "model"), (2, "data")]),
    (r"embed$", [(0, "model"), (1, "data")]),
    (r"lm_head$", [(1, "model"), (0, "data")]),
    (r"(wq|wk|wv|w_gate|w_up|w_in|in_proj)$", [(1, "model"), (0, "data")]),
    (r"(wo|w_down|w_out|out_proj)$", [(0, "model"), (1, "data")]),
    (r"router$", [(1, "data")]),
    (r"conv_w$", [(1, "model")]),
    (r"conv_b$", [(0, "model")]),
]


def _param_spec(path: str, shape: Sequence[int], linear: bool,
                axis_sizes: AxisSizes, fsdp: bool) -> Spec:
    for pat, prefs in _PARAM_RULES:
        if re.search(pat, path):
            prefs = [(1 - d if linear else d, a) for (d, a) in prefs
                     if fsdp or a != "data"]
            return _assign(shape, prefs, axis_sizes)
    return (None,) * len(shape)   # norms, scalars, biases: replicated


def rule_path(name: str) -> str:
    """The reference's path of a port module path: layer indices dropped,
    "/" for "." ("layers.3.attn.wq" -> "layers/attn/wq")."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _leaves(module: nn.Module) -> Iterator[Tuple[str, torch.Tensor, str,
                                                 bool]]:
    """(parameter name, tensor, rule path, is an nn.Linear weight)."""
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            linear = isinstance(mod, nn.Linear) and pname == "weight"
            path = mname if linear else (f"{mname}.{pname}" if mname
                                         else pname)
            yield (f"{mname}.{pname}" if mname else pname, p,
                   rule_path(path), linear)


def param_specs(module: nn.Module, axis_sizes: AxisSizes, *,
                fsdp: bool = True) -> Dict[str, Spec]:
    """{parameter name: spec} of a module (on any device, meta included)."""
    return {name: _param_spec(path, tuple(p.shape), linear, axis_sizes,
                              fsdp)
            for name, p, path, linear in _leaves(module)}


def serving_param_specs(module: nn.Module, axis_sizes: AxisSizes
                        ) -> Dict[str, Spec]:
    """TP only (no FSDP): decode latency cannot afford per-step
    allgathers."""
    return param_specs(module, axis_sizes, fsdp=False)


def opt_specs(param_spec: Dict[str, Spec], keep_master: bool = False
              ) -> Dict[str, Any]:
    """AdamW state: step replicated; mu, nu (and an fp32 master copy, where
    one is kept) mirror the param specs.  The port's trainer keeps its
    masters as the parameters themselves, so it asks for none."""
    out = {"step": (), "mu": dict(param_spec), "nu": dict(param_spec)}
    out["master"] = dict(param_spec) if keep_master else None
    return out


def _batch_group(axis_sizes: AxisSizes) -> Tuple[Any, int]:
    """The batch axes as one spec entry (a name, or a tuple of names as the
    reference's PartitionSpec keeps it) and their product."""
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    group = 1
    for a in axes:
        group *= axis_sizes[a]
    entry = axes[0] if len(axes) == 1 else (axes or None)
    return entry, group


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(getattr(x, "shape", ()))


def batch_specs(batch: Dict[str, Any], axis_sizes: AxisSizes
                ) -> Dict[str, Spec]:
    """Shard the batch dim over (pod, data) when divisible."""
    entry, group = _batch_group(axis_sizes)
    out = {}
    for k, v in batch.items():
        shape = _shape(v)
        spec = [None] * len(shape)
        if shape and _fits(shape[0], group):
            spec[0] = entry
        out[k] = tuple(spec)
    return out


def _map_tree(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, f"{prefix}/{i}" if prefix
                                    else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def decode_state_specs(state: Any, cfg, axis_sizes: AxisSizes) -> Any:
    """KV caches [L,B,T,H,D]: batch over (pod,data) when divisible; heads
    over model, falling back to head_dim then cache length.  SSM states
    [L,B,H,P,N] (and conv states [L,B,W-1,C]): heads over model, with
    fallbacks.  Encoder outputs [B,T,d]: batch + d.  The spec tree has the
    state's structure."""
    dentry, dgroup = _batch_group(axis_sizes)
    msize = axis_sizes.get("model", 1)

    def assign(p: str, leaf: Any) -> Spec:
        shape = _shape(leaf)
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and _fits(shape[1], dgroup):
            spec[1] = dentry         # batch dim (after layer stack dim)
        if p.startswith("kv") and len(shape) == 5:
            for dim in (3, 4, 2):    # heads, head_dim, cache length
                if _fits(shape[dim], msize):
                    spec[dim] = "model"
                    break
        elif p.startswith("ssm") and len(shape) >= 4:
            for dim in (2, 3, len(shape) - 1):
                if _fits(shape[dim], msize):
                    spec[dim] = "model"
                    break
        elif p.startswith("enc_out") and len(shape) == 3:
            if _fits(shape[0], dgroup):
                spec = [dentry, None, None]
            if _fits(shape[2], msize):
                spec[2] = "model"
        return tuple(spec)

    return _map_tree(state, assign)


# ---------------------------------------------------------------------- #
# placements
# ---------------------------------------------------------------------- #

def to_placements(spec: Spec, mesh) -> list:
    """One `Shard(d)` or `Replicate()` per mesh dim: mesh dim `a` shards
    the tensor dim whose entry names `a` (alone or in a tuple, whose order
    is the mesh's: ("pod", "data") shards pod-major)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def place(t: torch.Tensor, mesh, spec: Spec):
    """`t` (the whole tensor, on every rank alike) as a DTensor of `spec`'s
    placements: each rank keeps its own chunk, with no scatter.  A chunk
    that is a view of `t` is copied, so `t` itself can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    dt = distribute_tensor(t, mesh, to_placements(spec, mesh),
                           src_data_rank=None)
    local = dt.to_local()
    if local.numel() < t.numel() and \
            local.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr():
        dt = DTensor.from_local(local.clone(), mesh, dt.placements,
                                run_check=False, shape=dt.shape,
                                stride=dt.stride())
    return dt


def set_parameter(module: nn.Module, name: str, value: torch.Tensor
                  ) -> None:
    """Put `value` in as parameter `name` (dotted) of `module`."""
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf,
            nn.Parameter(value))


def distribute_module(module: nn.Module, mesh, specs: Dict[str, Spec]
                      ) -> nn.Module:
    """Swap every parameter of `module` (whole on every rank alike) for a
    DTensor parameter of its spec's placements, in place."""
    for name, p in list(module.named_parameters()):
        set_parameter(module, name, place(p.detach(), mesh, specs[name]))
    return module


def distribute_tree(tree: Any, mesh, specs: Any) -> Any:
    """Every tensor of `tree` (dicts, lists, tuples) placed by the spec at
    the same place in `specs`."""
    def spec_at(path: str) -> Spec:
        node = specs
        for key in path.split("/"):
            node = node[key] if isinstance(node, dict) else node[int(key)]
        return node

    return _map_tree(tree, lambda p, t: place(t, mesh, spec_at(p))
                     if isinstance(t, torch.Tensor) else t)


def local_shape(shape: Sequence[int], spec: Spec, axis_sizes: AxisSizes
                ) -> Tuple[int, ...]:
    """The shape of one rank's chunk of a tensor of `shape` under `spec`
    (the chunks of a divisible split are equal)."""
    out = []
    for size, entry in zip(shape, spec):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        div = 1
        for a in axes:
            div *= axis_sizes[a]
        out.append(size // div)
    return tuple(out) + tuple(shape[len(spec):])


def local_bytes(shape: Sequence[int], spec: Spec, axis_sizes: AxisSizes,
                itemsize: int) -> int:
    """Bytes of one rank's chunk of a tensor of `shape` under `spec`."""
    n = itemsize
    for size in local_shape(shape, spec, axis_sizes):
        n *= size
    return n
