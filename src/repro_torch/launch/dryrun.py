"""Multi-pod dry run: prove the distribution config is coherent, and count
what each device would do.  Counterpart of src/repro/launch/dryrun.py.

For every (architecture x input shape) cell, on the single-pod 16x16 mesh
and the multi-pod 2x16x16 mesh of a "fake" process group (256 or 512
ranks, no communication, this process playing rank 0), the model is built
on the meta device, its parameters, optimizer state, batch and decode state
are placed as DTensors of fake tensors by the sharding policy
(repro_torch.launch.sharding), and one step runs under `FakeTensorMode`
with the activation policy installed: the train step (loss and backward
with remat, then the AdamW update of float32 masters and the bfloat16
parameters cast from them), a prefill, or one decode step against a cache
of seq_len.  No memory is allocated and no kernel launches; the hand-
written kernels are reached through their custom ops' fake
implementations and FLOP formulas.

Each cell records, per device: the counts of `analysis.hlo_count`
(matmul FLOPs, bytes, collective wire bytes and ops by kind), the argument
bytes (the local shards of params, optimizer state, batch and decode
state), the peak bytes of the storages the step allocates on top of them,
and the roofline row against the card (`analysis.roofline`).

--device cuda (the default) makes fake CUDA tensors, so attention takes
the flash kernel's op as on the card; that needs a CUDA build of PyTorch
(a CPU-only build cannot index a fake CUDA tensor), but no card.
--device cpu runs anywhere, with attention on its plain paths.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both --out DIR
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.hlo_count import Counter, uncounted
from repro_torch.analysis.roofline import RooflineTerms, model_flops_for
from repro_torch.configs import (ARCHS, ALL_SHAPES, get_config,
                                 shape_by_name, skip_reason)
from repro_torch.models.common import (ActivationSharding, recorded_draws,
                                       set_activation_sharding)
from repro_torch.models.model_zoo import build_model
from repro_torch.models.moe import set_moe_groups
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_update

from .mesh import PRODUCTION_SHAPES, batch_axes, make_production_mesh, \
    mesh_axis_sizes
from .sharding import (batch_specs, decode_state_specs, local_shape,
                       opt_specs, param_specs, serving_param_specs,
                       set_parameter, to_placements)


# ---------------------------------------------------------------------- #
# inputs (fake tensors: never allocated)
# ---------------------------------------------------------------------- #

def batch_shapes(cfg, shape) -> Dict[str, Any]:
    """Model inputs for one step of the given kind: {name: (shape,
    dtype)}."""
    b = shape.global_batch
    toks = shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        toks = max(16, toks - cfg.num_image_tokens)
        out["patch_embed"] = ((b, cfg.num_image_tokens, cfg.d_model),
                              torch.bfloat16)
    if cfg.family == "audio":
        out["audio_embed"] = ((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    out["tokens"] = ((b, toks), torch.int32)
    return out


def seq_pad_for(cfg, n: int) -> int:
    """SSD chunked scan needs seq % chunk == 0 (all our shapes satisfy it)."""
    if cfg.ssm_state_dim and n % cfg.ssm_chunk:
        n += cfg.ssm_chunk - n % cfg.ssm_chunk
    return n


def install_activation_policy(mesh) -> None:
    """Residual stream [B,S,d]: batch over (pod,data), sequence over model
    (Megatron-style sequence parallelism -- norms stay local, attention and
    MLP re-gather).  Logits [B,S,V]: vocab over model.  constrain() skips
    any tensor whose dims don't divide (decode's S=1, whisper's odd vocab).
    The reference's policy, candidate for candidate."""
    bx = batch_axes(mesh)
    b = bx[0] if len(bx) == 1 else bx

    def at(*spec):
        return ActivationSharding(mesh, spec,
                                  tuple(to_placements(spec, mesh)))
    set_activation_sharding({
        "residual": at(b, "model", None),
        "logits": at(b, None, "model"),
        # attention q/k/v [B,S,H,D]: heads over model; archs with fewer
        # heads than the axis fall back to batch over every axis, then
        # batch-over-data only (attention replicated across model)
        "attn_qkv": [at(b, None, "model", None),
                     at(bx + ("model",), None, None, None),
                     at(b, None, None, None)],
        # GQA kv before local expansion: model-replicated
        "attn_kv_full": at(b, None, None, None),
        # MoE grouped dispatch: groups = data shards; expert ffn on model
        "moe_tokens": at(b, None, None),
        "moe_dispatch": at(b, None, None, None),
    })
    sizes = mesh_axis_sizes(mesh)
    set_moe_groups(math.prod(sizes[a] for a in bx) if bx else 1)


@contextlib.contextmanager
def activation_policy(mesh):
    """The policy and the MoE groups for the duration of one cell."""
    install_activation_policy(mesh)
    try:
        yield
    finally:
        set_activation_sharding(None)
        set_moe_groups(1)


@contextlib.contextmanager
def _strided_shards_outside_fake():
    """DTensor's _StridedShard (what a view flattening [B, S] with both
    dims split gives) finds its local size from an index tensor of the
    whole dim that it builds, splits and reads back.  Under the fake mode
    that tensor would be fake and unreadable, so the method runs outside
    it, and uncounted: it is bookkeeping, no rank's work."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    orig = cls.__dict__.get("local_shard_size_and_offset") if cls else None
    if not callable(orig):
        yield
        return

    def outside(*a, **k):
        with unset_fake_temporarily(), uncounted():
            return orig(*a, **k)
    cls.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def fake_group(world: int) -> None:
    """A "fake" default process group of `world` ranks (this process is
    rank 0; collectives move nothing), made or remade at that size."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != world):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def fake_mesh(multi_pod: bool, device: str):
    """The production mesh over a "fake" process group of 256 (512)
    ranks."""
    fake_group(math.prod(PRODUCTION_SHAPES[multi_pod][0]))
    return make_production_mesh(multi_pod=multi_pod, device_type=device)


def fake_dtensor(shape, dtype, spec, mesh, device) -> torch.Tensor:
    """A DTensor of global `shape` placed by `spec`, its local shard a
    fake tensor (call under FakeTensorMode)."""
    from torch.distributed.tensor import DTensor
    sizes = mesh_axis_sizes(mesh)
    local = torch.empty(local_shape(shape, spec, sizes), dtype=dtype,
                        device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def meta_module(model, dtype) -> torch.nn.Module:
    """The model's module on the meta device, nothing drawn (made outside
    the fake mode, whose tensors a module cannot swap in)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily(), recorded_draws():
        return model._init_fn()(model.cfg, None, dtype, "meta")


def placed_module(model, dtype, specs, mesh, device) -> torch.nn.Module:
    """The module with every parameter a fake DTensor of its spec."""
    module = meta_module(model, dtype)
    for name, p in list(module.named_parameters()):
        set_parameter(module, name, fake_dtensor(
            tuple(p.shape), dtype, specs[name], mesh, device))
    return module


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module):
            n += local_bytes([p for p in t.parameters()])
        elif isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            n += t.numel() * t.element_size()
    return n


# ---------------------------------------------------------------------- #
# one cell
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skip: Optional[str] = None
    error: Optional[str] = None
    seconds: float = 0.0
    memory: Optional[Dict[str, float]] = None
    cost: Optional[Dict[str, float]] = None
    collective_bytes: Optional[Dict[str, int]] = None
    collective_ops: Optional[Dict[str, int]] = None
    roofline: Optional[Dict[str, Any]] = None


def _train_step(model, cfg, shape, mesh, device, counter: Counter) -> int:
    """bf16 params, f32 master + moments (the reference's layout): loss
    and backward with remat, the AdamW update of the masters, and the
    params cast from them.  Returns the argument bytes."""
    meta = meta_module(model, torch.bfloat16)
    p_spec = param_specs(meta, mesh_axis_sizes(mesh), fsdp=True)
    o_spec = opt_specs(p_spec, keep_master=True)
    params = placed_module(model, torch.bfloat16, p_spec, mesh, device)
    masters = placed_module(model, torch.float32, o_spec["master"], mesh,
                            device)
    state = AdamWState(0, *({n: fake_dtensor(
        tuple(p.shape), torch.float32, o_spec[k][n], mesh, device)
        for n, p in meta.named_parameters()} for k in ("mu", "nu")))
    batch = _batch(cfg, shape, mesh, device)
    args = {"params": local_bytes(params), "master": local_bytes(masters),
            "mu": local_bytes(state.mu), "nu": local_bytes(state.nu),
            "batch": local_bytes(batch)}
    with counter:
        total, _ = model.loss(params, batch)
        with implicit_replication():    # remat's recomputation runs here
            total.backward()
        grads = {}
        for name, p in params.named_parameters():
            g = p.grad
            if g is None:
                # unused at a cut depth (a hybrid stack short of its first
                # shared site): a zero gradient, as jax.grad gives
                g = torch.zeros_like(p)
            if g.placements != p.placements:
                g = g.redistribute(mesh, p.placements)
            grads[name] = g
        adamw_update(AdamWConfig(), grads, state, masters)
        with torch.no_grad():
            for (_, p), (_, m) in zip(params.named_parameters(),
                                      masters.named_parameters()):
                p.copy_(m)
    return args


def _batch(cfg, shape, mesh, device) -> Dict[str, torch.Tensor]:
    shapes = batch_shapes(cfg, shape)
    specs = batch_specs({k: torch.empty(s, device="meta")
                         for k, (s, _) in shapes.items()},
                        mesh_axis_sizes(mesh))
    return {k: fake_dtensor(s, dt, specs[k], mesh, device)
            for k, (s, dt) in shapes.items()}


def _serving_state(model, cfg, shape, mesh, device):
    """Serving params (TP only) and the decode state of seq_len rows, as
    fake DTensors."""
    meta = meta_module(model, torch.bfloat16)
    sizes = mesh_axis_sizes(mesh)
    params = placed_module(model, torch.bfloat16,
                           serving_param_specs(meta, sizes), mesh, device)
    seq = seq_pad_for(cfg, shape.seq_len)
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        state = model.init_decode_state(shape.global_batch, seq,
                                        torch.bfloat16, "meta")
    def placed(t, spec):
        if isinstance(t, dict):
            return {k: placed(v, spec[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(placed(v, sp) for v, sp in zip(t, spec))
        return fake_dtensor(tuple(t.shape), t.dtype, spec, mesh, device)
    return params, placed(state, decode_state_specs(state, cfg, sizes))


def _prefill_step(model, cfg, shape, mesh, device, counter: Counter) -> int:
    params, state = _serving_state(model, cfg, shape, mesh, device)
    batch = _batch(cfg, shape, mesh, device)
    args = {"params": local_bytes(params), "state": local_bytes(state),
            "batch": local_bytes(batch)}
    with counter, torch.no_grad():
        model.prefill(params, batch, state)
    return args


def _decode_step(model, cfg, shape, mesh, device, counter: Counter) -> int:
    params, state = _serving_state(model, cfg, shape, mesh, device)
    token = _batch(cfg, dataclasses.replace(shape, seq_len=1), mesh,
                   device)["tokens"]
    if cfg.family == "vlm":       # _batch pads a vlm prompt to 16 tokens
        token = fake_dtensor((shape.global_batch, 1), torch.int32,
                             batch_specs({"t": token}, mesh_axis_sizes(
                                 mesh))["t"], mesh, device)
    args = {"params": local_bytes(params), "state": local_bytes(state),
            "batch": local_bytes(token)}
    with counter, torch.no_grad():
        model.decode_step(params, token, state, shape.seq_len - 1)
    return args


_STEPS = {"train": _train_step, "prefill": _prefill_step,
          "decode": _decode_step}


def count_step(cfg, shape, mesh, device: str
               ) -> Tuple[Counter, Dict[str, int]]:
    """One step of `shape`'s kind of `cfg` on `mesh` (a DeviceMesh of a
    fake process group), under the fake mode and the activation policy:
    (its Counter, the argument bytes per device by part: params, master,
    mu, nu and batch, or params, decode state and batch)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(cfg, remat=shape.kind == "train")
    counter = Counter()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            _strided_shards_outside_fake(), activation_policy(mesh):
        args = _STEPS[shape.kind](model, cfg, shape, mesh, device, counter)
    return counter, args


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               device: str = "cuda", layers: Optional[int] = None
               ) -> CellResult:
    """One cell on its fake mesh: counted per device, or skipped, or the
    error it raised.  `layers` cuts the depth (each family's stack, the
    encoder's too), never a width."""
    cfg = dataclasses.replace(get_config(arch), dtype=torch.bfloat16)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, encoder_layers=min(
            cfg.encoder_layers, layers))
    shape = shape_by_name(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(arch, shape)
    if reason:
        return CellResult(arch, shape_name, mesh_name, ok=True, skip=reason)

    t0 = time.time()
    try:
        mesh = fake_mesh(multi_pod, device)
        chips = mesh.size()
        counter, args = count_step(cfg, shape, mesh, device)
        counted = counter.totals()
        coll = counted["collective_bytes"]
        arg_bytes = sum(args.values())
        mem = {"argument_size_in_bytes": float(arg_bytes),
               "temp_size_in_bytes": float(counter.peak_bytes),
               "total_per_device": float(arg_bytes + counter.peak_bytes),
               "arguments": {k: float(v) for k, v in args.items()}}
        cost = {"flops": counted["flops"], "bytes accessed": counted["bytes"]}
        terms = RooflineTerms(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops=counted["flops"], hlo_bytes=counted["bytes"],
            collective_bytes=coll, model_flops=model_flops_for(cfg, shape))
        return CellResult(arch, shape_name, mesh_name, ok=True,
                          seconds=time.time() - t0, memory=mem, cost=cost,
                          collective_bytes=coll,
                          collective_ops=counted["collective_ops"],
                          roofline=terms.row())
    except Exception:  # noqa: BLE001 -- any failure is a bug report
        return CellResult(arch, shape_name, mesh_name, ok=False,
                          seconds=time.time() - t0,
                          error=traceback.format_exc(limit=6))


def check_device(device: str) -> None:
    """Fake CUDA tensors need a CUDA build of PyTorch (no card)."""
    if device == "cuda" and torch.version.cuda is None:
        raise SystemExit("--device cuda needs a CUDA build of PyTorch (fake "
                         "CUDA tensors cannot be indexed in a CPU-only "
                         "build); pass --device cpu")


# ---------------------------------------------------------------------- #
# CLI
# ---------------------------------------------------------------------- #

def format_line(r: CellResult) -> str:
    tag = f"{r.arch}/{r.shape}/{r.mesh}"
    if r.skip:
        return f"SKIP {tag}: {r.skip}"
    if r.ok:
        rf = r.roofline
        return (f"OK   {tag} [{r.seconds:.1f}s] "
                f"mem/dev={r.memory['total_per_device'] / 2 ** 30:.2f}GiB "
                f"dominant={rf['dominant']} "
                f"compute={rf['compute_s'] * 1e3:.2f}ms "
                f"memory={rf['memory_s'] * 1e3:.2f}ms "
                f"collective={rf['collective_s'] * 1e3:.2f}ms")
    return f"FAIL {tag} [{r.seconds:.1f}s]\n{r.error}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, help="input-shape name")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--multi-pod", choices=("on", "off", "both"),
                    default="off")
    ap.add_argument("--out", default=None, help="JSON output directory")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the fake tensors")
    args = ap.parse_args(argv)
    check_device(args.device)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    pods = {"on": [True], "off": [False], "both": [False, True]}[
        args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                r = lower_cell(arch, shape, multi_pod=mp, device=args.device)
                results.append(r)
                print(format_line(r), flush=True)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{arch}__{shape}__{r.mesh}.json".replace("/", "_")
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(dataclasses.asdict(r), f, indent=1)
    bad = [r for r in results if not r.ok]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
