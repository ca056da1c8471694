"""Training entry point: training of every model family (dense, moe, vlm,
audio, ssm, hybrid) over a (data, model) mesh, with gradients carried by
the paper's pipeline allreduce or by torch's own, under the fault-tolerant
supervisor.  Counterpart of src/repro/launch/train.py.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --steps 3 --global-batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --device cpu --data-parallel 4 --collectives pipeline \
        --schedule-cache /tmp/sc --inject-fault 1:0-1
    PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \
        --reduced --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --device cpu --data-parallel 2 --model-parallel 2

--seq counts text tokens, as in the reference: a vlm batch adds its
num_image_tokens patch rows, an audio batch its encoder_seq frames (the
stub frontends' outputs, `train.data`).  An ssm or hybrid sequence that is
a multiple of the config's ssm_chunk takes the chunked scan, any other the
sequential recurrence.

Runs on CUDA unless --device cpu is given; without a card it raises.
--data-parallel D and --model-parallel M spawn D x M ranks with
torch.multiprocessing on a (D, M) ("data", "model") mesh: NCCL over D x M
cards (no more than the card count), gloo under --device cpu.  Each data
rank draws its rows of the global batch.  --collectives torch (the
reference's default, its "xla") places params and AdamW state by
`param_specs(fsdp=True)` as DTensors (FSDP over "data", tensor parallelism
over "model"), and each gradient comes back reduce-scattered to its
param's shards; every family, so at M = 1 and D > 1 each trains FSDP over
a (D, 1) mesh, as the reference does.
--collectives pipeline (M = 1 only, as in the reference) keeps whole params
on every rank and reduces gradients with a BucketedAllReduce built from
the data axis's bandwidth-optimal allreduce schedule (a bidirectional
ring, the reference's axis model).  With one rank no collective runs.
Params and AdamW state are fp32; compute is bf16 at full width and fp32
with --reduced.

Every step runs under `TrainSupervisor`: a checkpoint every --ckpt-every
steps and at the end (under --ckpt-dir; each rank of several writes its own
`rank<r>` directory), a crash restores the latest one and replays, and a
link fault (--inject-fault step:u-v) repairs the data axis's schedules in
place (`CollectiveContext.hot_swap`) and retries the step.  Rank 0 prints
each step's loss and ends with `done at step N; stragglers: S; link faults
repaired: R`.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import time
from typing import Dict, List, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--collectives", default="torch",
                    choices=("torch", "pipeline"),
                    help="torch: FSDP+TP placements, gradients "
                         "reduce-scattered by torch.distributed.  pipeline: "
                         "a BucketedAllReduce over the data axis's "
                         "bandwidth-optimal allreduce schedule (requires "
                         "--model-parallel 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_launch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--schedule-cache", default="",
                    help="pre-compile the per-axis tree-pipeline collective "
                         "programs into this on-disk artifact cache (later "
                         "launches and any pipeline-collectives consumer "
                         "load them instead of compiling)")
    ap.add_argument("--inject-fault", default="",
                    help="'step:u-v' — raise a LinkFault for link u-v at "
                         "that step.  The supervisor's on_link_fault hook "
                         "repairs the affected per-axis schedules in place "
                         "(CollectiveContext.hot_swap) and retries the same "
                         "step without restoring a checkpoint")
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dp, mp = args.data_parallel, args.model_parallel
    if dp < 1 or args.global_batch % dp:
        raise SystemExit(f"--global-batch {args.global_batch} must split "
                         f"over --data-parallel {dp}")
    if mp < 1:
        raise SystemExit(f"--model-parallel {mp} must be at least 1")
    if args.collectives == "pipeline" and mp != 1:
        raise SystemExit("--collectives pipeline requires "
                         "--model-parallel 1")
    world = dp * mp
    if world == 1:
        run(args)
        return 0

    import torch
    import torch.multiprocessing as mproc

    from repro_torch.models.common import resolve_device

    if resolve_device(args.device).type == "cuda" \
            and world > torch.cuda.device_count():
        raise SystemExit(f"--data-parallel {dp} x --model-parallel {mp} "
                         f"needs {world} cards, have "
                         f"{torch.cuda.device_count()}")
    mproc.spawn(_rank_main, args=(args, _free_port()), nprocs=world,
                join=True)
    return 0


def _rank_main(rank: int, args: argparse.Namespace, port: int) -> None:
    import torch
    import torch.distributed as dist
    world = args.data_parallel * args.model_parallel
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "gloo":    # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        run(args, rank, world)
    finally:
        dist.destroy_process_group()


def _placed_train_state(model, seed: int, device, mesh):
    """fp32 master params from `seed`, made one parameter at a time and
    placed by `param_specs(fsdp=True)`, and AdamW state whose moments
    carry the same placements (`opt_specs`)."""
    import torch

    from repro_torch.train import init_adamw

    from .mesh import mesh_axis_sizes
    from .sharding import param_specs, place, set_parameter

    module, leaves = model.init_leaves(seed, torch.float32, device)
    specs = param_specs(module, mesh_axis_sizes(mesh), fsdp=True)
    for name, whole in leaves:
        set_parameter(module, name, place(whole, mesh, specs[name]))
        del whole
    return module, init_adamw(module)


def _placed_batch(local: Dict, global_batch: int, mesh) -> Dict:
    """This data rank's rows as DTensors of `batch_specs`' placements
    (rows over "data", replicated over "model")."""
    import torch
    from torch.distributed.tensor import DTensor

    from .mesh import mesh_axis_sizes
    from .sharding import batch_specs, to_placements

    shapes = {k: torch.empty((global_batch,) + tuple(v.shape[1:]),
                             device="meta") for k, v in local.items()}
    specs = batch_specs(shapes, mesh_axis_sizes(mesh))
    return {k: DTensor.from_local(v, mesh, to_placements(specs[k], mesh),
                                  run_check=False)
            for k, v in local.items()}


def run(args: argparse.Namespace, rank: int = 0, world: int = 1,
        keep: Optional[dict] = None, mesh=None) -> List[Dict[str, float]]:
    """Train on this rank under the supervisor; returns one record per step
    run, replays included (step, loss, token loss, grad norm, seconds, text
    tokens of the global batch).  `keep`, if given, receives the final
    "state".
    With world > 1 under --collectives torch, or a `mesh` given (a
    ("data", "model") DeviceMesh; a 1 x 1 mesh runs the placed path on one
    card), params, AdamW state and batch are DTensors."""
    import torch

    from repro_torch.api import Collectives
    from repro_torch.comms import P2P, CollectiveContext
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.common import resolve_device
    from repro_torch.train import (AdamWConfig, DataConfig, FaultInjector,
                                   TrainConfig, TrainSupervisor,
                                   host_batch_slice, init_train_state,
                                   make_train_step)

    dp, mp = args.data_parallel, args.model_parallel
    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, remat=True)
    if mesh is None and world > 1 and args.collectives == "torch":
        from .mesh import make_mesh
        mesh = make_mesh(dp, mp, device.type)
    if mesh is not None:
        from .mesh import mesh_axis_sizes
        say(f"mesh: {mesh_axis_sizes(mesh)}")
        params, opt = _placed_train_state(model, args.seed, device, mesh)
        data_rank = mesh.get_local_rank("data")
    else:
        params, opt = init_train_state(model, args.seed, device)
        data_rank = rank

    ctx = None
    if world == 1 and mesh is None:
        say("data-parallel 1: no collective runs")
    elif args.schedule_cache or args.collectives == "pipeline":
        # the mesh axes' programs through the facade: with a cache the
        # first launch compiles and persists them, later ones load them
        coll = Collectives(cache=args.schedule_cache or None)
        ctx = CollectiveContext({"data": dp, "model": mp}, collectives=coll)
        say(ctx.describe())
        if coll.cache is not None:
            say(coll.cache.describe())
        if args.collectives != "pipeline":
            say(ctx.compile_stats_report())

    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                                           total_steps=args.steps),
                     microbatches=args.microbatches,
                     compute_dtype=torch.float32 if args.reduced
                     else torch.bfloat16)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.global_batch,
                    num_image_tokens=cfg.num_image_tokens,
                    encoder_seq=cfg.encoder_seq if cfg.is_encoder_decoder
                    else 0, d_model=cfg.d_model)
    live = {}

    def build_step() -> None:
        """The train step with its gradient hook: built again after a hot
        swap, since a BucketedAllReduce keeps the programs it was built
        from.  Placed params need none: their gradients come back
        reduce-scattered to their shards."""
        grad_reduce = None
        if world > 1 and args.collectives == "pipeline":
            red = ctx.bucketed_allreduce("data", P2P(), wire_dtype=None)
            say(ctx.compile_stats_report())

            def grad_reduce(tree):
                return {k: v / world for k, v in red(tree).items()}
        live["step"] = make_train_step(model, tc, grad_reduce=grad_reduce)

    build_step()
    injector = (FaultInjector.parse(args.inject_fault)
                if args.inject_fault else None)
    per = args.global_batch // dp
    records = []

    def step_fn(step, state):
        if injector is not None:
            injector.check(step)
        t0 = time.perf_counter()
        batch = {k: v.to(device) for k, v in host_batch_slice(
            dc, step, data_rank * per, (data_rank + 1) * per).items()}
        if mesh is not None:
            batch = _placed_batch(batch, args.global_batch, mesh)
        params, opt, metrics = live["step"](*state, batch)
        loss = float(metrics["loss"])           # waits for the step
        seconds = time.perf_counter() - t0
        gnorm = float(metrics["grad_norm"])
        records.append(dict(step=step, loss=loss,
                            token_loss=float(metrics["token_loss"]),
                            grad_norm=gnorm, seconds=seconds,
                            tokens=args.global_batch * args.seq))
        say(f"step {step}: loss {loss:.6f} grad_norm {gnorm:.4f} "
            f"({seconds:.3f} s)", flush=True)
        return (params, opt), metrics

    def on_link_fault(fault):
        if ctx is None:
            say(f"[repair] {fault}: no collective context attached, "
                f"retrying step")
            return
        # repair is deterministic, so every rank swaps in the same programs
        reports = ctx.hot_swap(fault.transform_text)
        for axis, reps in reports.items():
            for r in reps:
                say(f"[repair] axis {axis} {r.kind}: "
                    f"{r.repair_time_s * 1000:.1f}ms "
                    f"warm=(solve={r.warm_solve},split={r.warm_split}) "
                    f"cached={r.cached}")
        build_step()

    ckpt_dir = args.ckpt_dir if world == 1 \
        else os.path.join(args.ckpt_dir, f"rank{rank}")
    os.makedirs(ckpt_dir, exist_ok=True)
    sup = TrainSupervisor(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
                          on_link_fault=on_link_fault)
    # log_every=0: step_fn prints every step's line itself
    state, final = sup.run(state=(params, opt), num_steps=args.steps,
                           step_fn=step_fn, log_every=0, log=say)
    say(f"done at step {final}; stragglers: {len(sup.monitor.flagged)}; "
        f"link faults repaired: {injector.fired if injector else False}")
    if keep is not None:
        keep["state"] = state
    return records


if __name__ == "__main__":
    sys.exit(main())
