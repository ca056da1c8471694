"""Training entry point: data-parallel training of the dense family with
gradients carried by the paper's pipeline allreduce or by torch's own.
Counterpart of src/repro/launch/train.py for --model-parallel 1.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --steps 3 --global-batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --reduced --device cpu --data-parallel 4 --collectives pipeline

Runs on CUDA unless --device cpu is given; without a card it raises.
--data-parallel N spawns N ranks with torch.multiprocessing, each with the
same seeded weights and its rows of the global batch: NCCL over N cards
(N may not exceed the card count), gloo under --device cpu.
--collectives pipeline reduces gradients with a BucketedAllReduce built from
the data axis's bandwidth-optimal allreduce schedule (a bidirectional ring,
the reference's axis model); torch uses torch.distributed.all_reduce.  With
one rank no collective runs.  Params and AdamW state are fp32; compute is
bf16 at full width and fp32 with --reduced.  Rank 0 prints each step's loss
and ends with `done at step N`.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--collectives", default="torch",
                    choices=("torch", "pipeline"),
                    help="torch: torch.distributed.all_reduce.  pipeline: "
                         "a BucketedAllReduce over the data axis's "
                         "bandwidth-optimal allreduce schedule")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    dp = args.data_parallel
    if dp < 1 or args.global_batch % dp:
        raise SystemExit(f"--global-batch {args.global_batch} must split "
                         f"over --data-parallel {dp}")
    if dp == 1:
        run(args)
        return 0

    import torch
    import torch.multiprocessing as mp

    from repro_torch.models.common import resolve_device

    if resolve_device(args.device).type == "cuda" \
            and dp > torch.cuda.device_count():
        raise SystemExit(f"--data-parallel {dp} needs {dp} cards, have "
                         f"{torch.cuda.device_count()}")
    mp.spawn(_rank_main, args=(args, _free_port()), nprocs=dp, join=True)
    return 0


def _rank_main(rank: int, args: argparse.Namespace, port: int) -> None:
    import torch
    import torch.distributed as dist
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "gloo":    # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.data_parallel))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=args.data_parallel, rank=rank)
    try:
        run(args, rank, args.data_parallel)
    finally:
        dist.destroy_process_group()


def run(args: argparse.Namespace, rank: int = 0, world: int = 1
        ) -> List[Dict[str, float]]:
    """Train on this rank; returns one record per step (loss, seconds,
    tokens of the global batch)."""
    import torch
    import torch.distributed as dist

    from repro_torch.comms import P2P, CollectiveContext
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.common import resolve_device
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   host_batch_slice, init_train_state,
                                   make_train_step)

    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, remat=True)
    params, opt = init_train_state(model, args.seed, device)

    grad_reduce = None
    if world == 1:
        say("data-parallel 1: no collective runs")
    elif args.collectives == "pipeline":
        ctx = CollectiveContext({"data": world})
        say(ctx.describe())
        red = ctx.bucketed_allreduce("data", P2P(), wire_dtype=None)

        def grad_reduce(tree):
            return {k: v / world for k, v in red(tree).items()}
    else:
        def grad_reduce(tree):
            for v in tree.values():
                dist.all_reduce(v)
            return {k: v / world for k, v in tree.items()}

    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                                           total_steps=args.steps),
                     microbatches=args.microbatches,
                     compute_dtype=torch.float32 if args.reduced
                     else torch.bfloat16)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.global_batch)
    step_fn = make_train_step(model, tc, grad_reduce=grad_reduce)
    per = args.global_batch // world
    records = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        batch = {k: v.to(device) for k, v in host_batch_slice(
            dc, step, rank * per, (rank + 1) * per).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])           # waits for the step
        seconds = time.perf_counter() - t0
        records.append(dict(step=step, loss=loss, seconds=seconds,
                            tokens=args.global_batch * args.seq))
        say(f"step {step}: loss {loss:.6f} grad_norm "
            f"{float(metrics['grad_norm']):.4f} ({seconds:.3f} s)",
            flush=True)
    say(f"done at step {args.steps}")
    return records


if __name__ == "__main__":
    sys.exit(main())
