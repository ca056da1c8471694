"""Serving entry point: random weights from --seed + batched engine, on one
card or tensor-parallel over several.  Counterpart of
src/repro/launch/serve.py.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --prompt-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --model-parallel 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --reduced --device cpu --model-parallel 4 --inject-fault 0-1

Serves every family: dense, moe (qwen2-moe-a2.7b; mixtral-8x7b's 93 GB of
bf16 weights do not fit one 80 GB card at its full depth), vlm
(paligemma-3b), audio (whisper-medium), ssm (mamba2-780m) and hybrid
(zamba2-1.2b).  A vlm or audio request carries its stub frontend's output
(patch_embed [P, d] or audio_embed [T_enc, d], standard normal times 0.02,
from a generator seeded with --seed and the request's uid); --max-len
counts text positions, and a vlm batch's caches add its P patch rows.
(The reference's launcher submits no extras, so its engine cannot serve
these two families.)  Runs on CUDA
unless --device cpu is given; without a card it raises.  Params are bf16
at full size and fp32 with --reduced.  Prompts have random lengths of 4-23
tokens, or --prompt-len each; an ssm or hybrid batch whose padded length is
a multiple of the config's ssm_chunk (512 for mamba2-780m, 256 for
zamba2-1.2b, 16 reduced) prefills through the SSD kernel, any other
through the sequential recurrence.

--model-parallel N spawns N ranks with torch.multiprocessing (NCCL over N
cards, N at most the card count; gloo under --device cpu) on a (1, N)
("data", "model") mesh, and serves with the params placed by
`serving_param_specs` as DTensors (tensor parallelism, every family).
Unless --no-broadcast-params is given, only model rank 0 makes the
weights from --seed: every parameter reaches every rank
through the paper's `tree_broadcast` over the model axis's broadcast
program (`CollectiveContext.broadcast_program("model")`), one parameter at
a time, and only then is each rank's shard kept, so a model larger than
one card is placed as it is made.  --inject-fault u-v fails link u-v of
the model axis after the broadcast program is compiled: the program is
repaired in place (`CollectiveContext.hot_swap`) and the parameters
travel over the degraded fabric.  --schedule-cache warms an on-disk cache
with the model axis's programs.  Model rank 0 prints the `req` lines.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="tokens per prompt (default: random, 4-23)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--schedule-cache", default="",
                    help="pre-compile the model-axis tree-pipeline collective "
                         "programs into this on-disk artifact cache")
    ap.add_argument("--no-broadcast-params", action="store_true",
                    help="skip the tree-broadcast parameter distribution "
                         "(every rank makes the weights from --seed itself)")
    ap.add_argument("--inject-fault", default="",
                    help="'u-v' — fail link u-v on the model axis after the "
                         "broadcast schedule is compiled: the launcher "
                         "repairs the program in place "
                         "(CollectiveContext.hot_swap) and distributes "
                         "parameters over the degraded fabric")
    return ap


def frontend_stub(cfg, seed: int, uid: int):
    """The stub vision or audio frontend's output for request `uid`, or None
    for a family without one."""
    import numpy as np
    field, rows = {"vlm": ("patch_embed", cfg.num_image_tokens),
                   "audio": ("audio_embed", cfg.encoder_seq)}.get(
                       cfg.family, (None, 0))
    if not rows:
        return None
    rng = np.random.default_rng([seed, uid])
    return {field: rng.standard_normal((rows, cfg.d_model),
                                       dtype=np.float32) * 0.02}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    mp = args.model_parallel
    if mp < 1:
        raise SystemExit(f"--model-parallel {mp} must be at least 1")
    if mp == 1:
        serve(args)
        return 0

    import torch
    import torch.multiprocessing as mproc

    from repro_torch.models.common import resolve_device

    from .train import _free_port

    if resolve_device(args.device).type == "cuda" \
            and mp > torch.cuda.device_count():
        raise SystemExit(f"--model-parallel {mp} needs {mp} cards, have "
                         f"{torch.cuda.device_count()}")
    mproc.spawn(_rank_main, args=(args, _free_port()), nprocs=mp, join=True)
    return 0


def _rank_main(rank: int, args: argparse.Namespace, port: int) -> None:
    import torch
    import torch.distributed as dist
    mp = args.model_parallel
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "gloo":    # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // mp))
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=mp, rank=rank)
    try:
        serve(args, rank, mp)
    finally:
        dist.destroy_process_group()


def _placed_params(model, args, mesh, ctx, device, dtype, say):
    """The weights of `model.init(args.seed, dtype, device)`, one parameter
    at a time: from model rank 0 through `tree_broadcast` over the model
    axis (unless --no-broadcast-params), each placed by
    `serving_param_specs` as it arrives."""
    import time

    import torch

    from repro_torch.comms import P2P, tree_broadcast

    from .mesh import mesh_axis_sizes
    from .sharding import place, serving_param_specs, set_parameter

    mp = mesh_axis_sizes(mesh)["model"]
    broadcast = ctx is not None and mp > 1 and not args.no_broadcast_params
    root = mesh.get_local_rank("model") == 0
    module, leaves = model.init_leaves(args.seed, dtype, device,
                                       draw=root or not broadcast)
    specs = serving_param_specs(module, mesh_axis_sizes(mesh))
    if broadcast:
        prog = ctx.broadcast_program("model", root=0)
        if args.inject_fault:
            # a link died between boot and parameter distribution: repair
            # the compiled broadcast (and the axis's other programs) and
            # carry on over the degraded fabric
            from repro_torch.train import LinkFault
            u_s, v_s = args.inject_fault.split("-", 1)
            fault = LinkFault(int(u_s), int(v_s))
            say(f"[repair] injected {fault}")
            for axis, reps in ctx.hot_swap(fault.transform_text).items():
                for r in reps:
                    say(f"[repair] axis {axis} {r.kind}: "
                        f"{r.repair_time_s * 1e3:.1f}ms "
                        f"warm=(solve={r.warm_solve},split={r.warm_split})")
            prog = ctx.broadcast_program("model", root=0)
        comm = P2P(mesh.get_group("model"))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    seconds = 0.0
    for name, whole in leaves:
        if broadcast:
            sync()
            t0 = time.perf_counter()
            whole = tree_broadcast(whole, prog, comm)
            sync()
            seconds += time.perf_counter() - t0
        set_parameter(module, name, place(whole, mesh, specs[name]))
        del whole
    if broadcast:
        say(f"params distributed via tree broadcast (root=0, axis=model, "
            f"{mp} devices) in {seconds * 1e3:.0f} ms")
    return module


def serve(args: argparse.Namespace, rank: int = 0, world: int = 1,
          mesh=None, prompts: Optional[Sequence] = None):
    """Serve --requests on this rank (or the token arrays `prompts`, one
    request each); returns (engine, completions).  With world > 1 (a
    process group of `world` ranks) or a `mesh` given (a (data, model)
    DeviceMesh; a 1 x 1 mesh runs the placed path on one card) the params
    are DTensors placed by `serving_param_specs`."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.common import resolve_device
    from repro_torch.serve import Request, ServingEngine

    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", rank)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    model = build_model(cfg)
    if mesh is None and world > 1:
        from .mesh import make_mesh
        mesh = make_mesh(1, world, device.type)
    mp = 1 if mesh is None else mesh.size(
        mesh.mesh_dim_names.index("model"))
    ctx = None
    if args.schedule_cache or (mp > 1 and not args.no_broadcast_params):
        # serving restarts are frequent: warm the artifact cache with the
        # model axis's programs, so only the first boot compiles them; with
        # mp > 1 the context also gives the broadcast program that
        # distributes the parameters
        from repro_torch.api import Collectives
        from repro_torch.comms import CollectiveContext
        coll = Collectives(cache=args.schedule_cache or None)
        ctx = CollectiveContext({"data": 1, "model": mp}, collectives=coll)
        say(ctx.describe())
        if coll.cache is not None:
            say(coll.cache.describe())
    if mesh is None:
        params = model.init(args.seed, dtype, device)
    else:
        params = _placed_params(model, args, mesh, ctx, device, dtype, say)
    if ctx is not None:
        say(ctx.compile_stats_report())
    prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
    engine = ServingEngine(model, params, batch_size=args.batch_size,
                           max_len=args.max_len + prefix)
    if prompts is None:
        rng = np.random.default_rng(args.seed)
        prompts = [rng.integers(1, cfg.vocab_size, args.prompt_len
                                or int(rng.integers(4, 24)), dtype=np.int32)
                   for _ in range(args.requests)]
    for i, prompt in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=prompt,
                              max_new_tokens=args.new_tokens,
                              extras=frontend_stub(cfg, args.seed, i)))
    done = engine.run()
    for c in done:
        say(f"req {c.uid}: {c.prompt_len} prompt -> "
            f"{len(c.tokens) - c.prompt_len} new tokens "
            f"({c.latency_s * 1e3:.0f} ms batch)")
    return engine, done


if __name__ == "__main__":
    sys.exit(main())
