#!/usr/bin/env python3
"""Trace one training step and one gradient bucket's allreduce of the
PyTorch port on the card.

    python3 tools/trace_torch_train.py [--seq 4096 --batch 1]

1. train: gemma2-2b at full width (bf16 compute, fp32 masters and AdamW,
   per-layer recomputation, random weights from seed 0), one step of
   --batch x --seq tokens (4 x 512 by default: the train phase of
   chip_smoke.py; 1 x 4096 is its train_long phase).  After a warm-up step,
   the two halves of a step (`loss_and_grad`, `adamw_update`) are timed on
   the host clock with a sync after each, then one whole step runs under
   torch.profiler.  Above 2048 rows attention is blockwise, and each kv
   block's step is recomputed in the backward: `loss_and_grad` is timed
   again with that recomputation off (the probabilities kept instead,
   which one layer's backward at a time can hold), and the difference is
   what the recomputation costs.
2. allreduce: one 64 MiB-per-rank gradient bucket of 8 ranks stacked on the
   card, through BucketedAllReduce.reduce_bucket on the default data-axis
   model (a bidirectional ring) and on dgx:8, timed after a warm-up and
   then traced.

Each JSON line gives host seconds, device busy seconds (the sum of kernel
and copy times, which do not overlap on one stream), the idle share, kernel
launches, host-to-device copies and syncs, and the kernels that take the
most device time.  Host times under the profiler are inflated by its own
cost; the untraced times are printed beside them.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

SEED, ARCH, RANKS = 0, "gemma2-2b", 8


def _summary(prof, wall_s: float, steps: int) -> dict:
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in on_device) / 1e6
    host = {e.key: e.count for e in events}
    return dict(
        steps=steps, traced_wall_s=wall_s, device_busy_s=busy_s,
        idle_share=1 - busy_s / wall_s,
        kernel_launches_per_step=host.get("cudaLaunchKernel", 0) / steps,
        memcpy_per_step=host.get("cudaMemcpyAsync", 0) / steps,
        syncs_per_step=host.get("cudaStreamSynchronize", 0) / steps,
        top_kernels=[[e.key[:80], e.self_device_time_total / 1e3, e.count]
                     for e in on_device[:8]])


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _traced(fn, steps: int = 1):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _summary(prof, wall, steps)


def _without_kv_recompute(fn):
    """fn() with the blockwise attention's per-kv-block recomputation
    off."""
    from repro_torch.models import attention
    saved = attention.checkpoint
    attention.checkpoint = lambda step, *args, **kw: step(*args)
    try:
        return fn()
    finally:
        attention.checkpoint = saved


def trace_train(batch_size: int, seq: int) -> None:
    from repro_torch.models import attention, build_model
    from repro_torch.configs import get_config
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   adamw_update, host_batch_slice,
                                   init_train_state, loss_and_grad,
                                   make_train_step)
    cfg = get_config(ARCH)
    model = build_model(cfg, remat=True)
    params, opt = init_train_state(model, SEED, "cuda")
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                                           total_steps=10),
                     compute_dtype=torch.bfloat16)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch_size)
    step = make_train_step(model, tc)
    batch = {k: v.cuda() for k, v in
             host_batch_slice(dc, 0, 0, batch_size).items()}
    (params, opt, _), warm_s = _timed(lambda: step(params, opt, batch))
    (_, grads, _), lg_s = _timed(
        lambda: loss_and_grad(model, params, batch, tc))
    (params, opt, _), opt_s = _timed(
        lambda: adamw_update(tc.optimizer, grads, opt, params))
    del grads
    for p in params.parameters():
        p.grad = None
    (params, opt, _), step_s = _timed(lambda: step(params, opt, batch))
    extra = {}
    if seq > attention.BLOCKWISE_THRESHOLD:
        torch.cuda.reset_peak_memory_stats()
        _, again_s = _timed(lambda: loss_and_grad(model, params, batch, tc))
        peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        _, kept_s = _timed(lambda: _without_kv_recompute(
            lambda: loss_and_grad(model, params, batch, tc)))
        for p in params.parameters():
            p.grad = None
        extra = dict(blockwise_calls_per_loss_and_grad=2 * cfg.num_layers,
                     loss_and_grad_again_s=again_s,
                     loss_and_grad_kv_kept_s=kept_s,
                     kv_recompute_s=again_s - kept_s,
                     kv_recompute_share=(again_s - kept_s) / again_s,
                     peak_gb_recompute=peak,
                     peak_gb_kv_kept=torch.cuda.max_memory_allocated() / 1e9)
    summary = _traced(lambda: step(params, opt, batch))
    print(json.dumps({"phase": "train", "arch": ARCH, "batch": batch_size,
                      "seq": seq, "first_step_s": warm_s,
                      "loss_and_grad_s": lg_s, "adamw_update_s": opt_s,
                      "step_s": step_s, **extra, **summary}), flush=True)


def trace_allreduce() -> None:
    from repro_torch.comms import CollectiveContext, Stacked
    elems = (64 << 20) // 4
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stack = torch.randn((RANKS, elems), generator=gen, device="cuda")
    for label, topo in (("data-ring8", None), ("dgx:8", "dgx:8")):
        ctx = CollectiveContext({"data": RANKS},
                                topologies={"data": topo} if topo else None)
        red = ctx.bucketed_allreduce("data", Stacked(RANKS),
                                     wire_dtype=None)
        red.reduce_bucket(stack)                       # warm-up
        _, wall = _timed(lambda: red.reduce_bucket(stack))
        summary = _traced(lambda: red.reduce_bucket(stack))
        print(json.dumps({
            "phase": "allreduce", "topology": label, "ranks": RANKS,
            "bucket_bytes_per_rank": elems * 4,
            "calls": red.rs_prog.num_calls + red.ag_prog.num_calls,
            "untraced_wall_s": wall, **summary}), flush=True)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch_train: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"phase": "device",
                      "name": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.strip()}), flush=True)
    trace_train(args.batch, args.seq)
    torch.cuda.empty_cache()
    trace_allreduce()
    return 0


if __name__ == "__main__":
    sys.exit(main())
