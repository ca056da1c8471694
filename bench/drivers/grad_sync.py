"""Driver of the gradient-sync cells: a configuration's gradient set
reduced over a data axis by the port's gradient hook, as its launcher
builds it (`CollectiveContext.bucketed_allreduce`).

The traffic mix gives the data axis (`ranks`), how its ranks are held
(`comm`: "stacked", every rank on one card, `repro_torch.comms.Stacked`;
"p2p", one process and card a rank, `repro_torch.comms.P2P` over NCCL),
its topology (a spec such as "dgx:8", or null for the launcher's own
data-axis model), the bucket size, the wire dtype (null: float32, as the
launcher passes) and the limits.

Inputs: every rank's float32 gradient of each bucket of the hook's
partition, standard normal, drawn on the card from (seed, rank, bucket)
in one call a rank and bucket.  Unit of work: one bucket's tensors through
`BucketedAllReduce.__call__`, the buckets in the hook's order, cycled
until the window's seconds have passed and a pass over every bucket (one
step's gradient sync) has ended, so that every window does whole passes.
Under "p2p" rank 0 decides when and sets the count every rank stops at in
the process group's store.

Check, after the window: the window holds the outputs of the pass under
way, so it ends holding every bucket's output of its last whole pass.
Each is held to the plain sum over ranks of regenerated inputs
(`reference.bucket_sum`): `sum_rel_err`, the largest |output - sum| over
every bucket, rank and element, over the sum's largest magnitude in that
bucket; `rank_mismatch`, the largest difference between a rank's output
and rank 0's (the ranks' outputs are copies of one reduced shard, so
exact); `missing`, outputs whose names, shapes or dtypes differ from the
bucket's, and buckets with no output.
"""
from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench.harness import RunContext, RunResult, load_reference
from bench.reference.bucket_sum import bucket_inputs, rank_sum
from bench.trace import DeviceTrace, Spans, mean_summary

from .common import free_port, peak_bytes, reset_peak, sync

SCHEDULE_CACHE = Path(__file__).resolve().parent.parent / "cache" / \
    "schedules"
WIRE = {None: None, "bfloat16": torch.bfloat16, "float16": torch.float16}
STOP_KEY = "bench_stop_at"
STOP_MARGIN = 4         # calls a rank may run past rank 0's decision


def run(ctx: RunContext) -> RunResult:
    tr = ctx.cell.traffic
    if tr["comm"] == "stacked":
        return _merge([_rank(ctx, 0, None)], ctx)
    import torch.multiprocessing as mp
    port = free_port()
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_worker, args=(ctx, r, port))
             for r in range(1, tr["ranks"])]
    for p in procs:
        p.start()
    try:
        parts = _worker(ctx, 0, port)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes exited with {bad}")
    return _merge(parts, ctx)


def _worker(ctx: RunContext, rank: int, port: int) -> Optional[List[dict]]:
    """One rank of a "p2p" cell; rank 0 returns every rank's part."""
    import datetime

    import torch.distributed as dist
    ranks = ctx.cell.traffic["ranks"]
    cpu = ctx.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=None if cpu
                            else torch.device("cuda", rank))
    try:
        part = _rank(ctx, rank, dist)
        parts = [None] * ranks if rank == 0 else None
        dist.gather_object(part, parts, dst=0)
        return parts
    finally:
        dist.destroy_process_group()


def _rank(ctx: RunContext, rank: int, dist) -> dict:
    """Set-up, window and check of one process: every rank under
    "stacked", rank `rank` under "p2p" (`dist` its torch.distributed)."""
    from repro_torch.api import Collectives
    from repro_torch.comms import (P2P, CollectiveContext, Stacked,
                                   partition_buckets)
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    ranks, stacked = tr["ranks"], tr["comm"] == "stacked"
    device = torch.device(ctx.device if stacked or ctx.device == "cpu"
                          else f"cuda:{rank}")
    local = list(range(ranks)) if stacked else [rank]
    shapes = {name: shape for name, shape, _ in
              load_reference(cfg["reference"]).layout(cfg)}

    topology = tr.get("topology")
    cc = CollectiveContext({"data": ranks},
                           topologies={"data": topology} if topology else None,
                           collectives=Collectives(cache=str(SCHEDULE_CACHE)))
    hook = cc.bucketed_allreduce(
        "data", Stacked(ranks) if stacked else P2P(),
        bucket_bytes=tr["bucket_bytes"], wire_dtype=WIRE[tr["wire_dtype"]])
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    buckets = partition_buckets(meta, hook.bucket_bytes)
    sizes = [sum(math.prod(shapes[k]) for k in b) for b in buckets]
    inputs = [bucket_inputs(ctx.seed, i, b, shapes, local, device, stacked)
              for i, b in enumerate(buckets)]
    largest = max(range(len(buckets)), key=sizes.__getitem__)
    for i in sorted({largest, 0}):          # warm-up: the largest, the first
        hook(inputs[i])
    sync(device)
    if dist is not None:
        dist.barrier()

    spans = Spans()
    held: List[dict] = []           # the outputs of the pass under way
    store = dist.distributed_c10d._get_default_store() if dist else None
    stop_at = None
    trace = DeviceTrace(spans) if ctx.trace else contextlib.nullcontext()
    reset_peak(device)
    with trace:
        sync(device)
        t0, t0_ns = time.perf_counter(), time.perf_counter_ns()
        calls = elems = 0
        starts: List[float] = []        # host clock at each pass's start
        while stop_at is None or calls < stop_at:
            b = calls % len(buckets)
            if b == 0:
                held = []
                starts.append(time.perf_counter())
            with spans.span("grad_sync.hook"):
                held.append(hook(inputs[b]))
            calls += 1
            elems += sizes[b]
            if stop_at is not None:
                continue
            if dist is None:
                if time.perf_counter() - t0 >= ctx.seconds:
                    stop_at = _whole_passes(calls, len(buckets))
            elif rank == 0:
                if time.perf_counter() - t0 >= ctx.seconds:
                    stop_at = _whole_passes(calls + STOP_MARGIN,
                                            len(buckets))
                    store.set(STOP_KEY, str(stop_at))
            elif store.check([STOP_KEY]):
                stop_at = int(store.get(STOP_KEY))
                if calls > stop_at:
                    raise RuntimeError(f"rank {rank} ran {calls} calls, "
                                       f"past the agreed {stop_at}")
        sync(device)
        window = time.perf_counter() - t0
    setup_s = t0 - ctx.t_start
    memory = peak_bytes(device)
    summary = trace.summary(window, t0_ns) if ctx.trace else None
    del inputs, trace

    per_call = sorted(b - a for n, a, b in spans.items
                      if n == "grad_sync.hook")
    ends = starts[1:] + [t0 + window]
    lines = [f"rank {rank}: {calls} calls, host seconds a call: min "
             f"{per_call[0] / 1e9!r} median "
             f"{per_call[len(per_call) // 2] / 1e9!r} max "
             f"{per_call[-1] / 1e9!r}",
             f"rank {rank}: seconds a pass (host, dispatch to dispatch, "
             f"the last to the window's close): "
             f"{[b - a for a, b in zip(starts, ends)]!r}"]
    if dist is not None and device.type == "cuda":
        lines.append(_nccl_yardstick(ctx, buckets, shapes, device, dist))
    checks = _check(ctx, held, buckets, shapes, device, stacked, dist)
    return dict(calls=calls, elems=elems, window=window, setup_s=setup_s,
                memory=memory, summary=summary, checks=checks, lines=lines)


def _whole_passes(calls: int, buckets: int) -> int:
    """The first count of calls at or after `calls` that ends a pass over
    every bucket: each window does whole gradient syncs."""
    return -(-calls // buckets) * buckets


def _check(ctx, held: List[dict], buckets, shapes, device, stacked,
           dist) -> Dict[str, float]:
    """Every bucket's output of the last whole pass against the plain sum
    over ranks."""
    ranks = ctx.cell.traffic["ranks"]
    worst = mismatch = 0.0
    missing = len(buckets) - len(held)
    for b, out in enumerate(held):
        names = buckets[b]
        lead = (ranks,) if stacked else ()
        if sorted(out) != sorted(names) or any(
                tuple(out[k].shape) != lead + tuple(shapes[k])
                or out[k].dtype != torch.float32 for k in names):
            missing += 1
            continue
        got = torch.cat([out[k].reshape(lead + (-1,)) for k in names], -1)
        held[b] = None                  # free the output once it is read
        want = rank_sum(ctx.seed, b, names, shapes, ranks, device)
        scale = want.abs().max().clamp_min(1e-30)
        worst = max(worst, float((got.double() - want).abs().max() / scale))
        if stacked:
            mismatch = max(mismatch, float((got - got[0]).abs().max()))
        else:
            first = got.clone()
            dist.broadcast(first, src=0)
            mismatch = max(mismatch, float((got - first).abs().max()))
        del got, want
    return {"sum_rel_err": worst, "rank_mismatch": mismatch,
            "missing": float(missing)}


def _nccl_yardstick(ctx, buckets, shapes, device, dist) -> str:
    """NCCL's own all_reduce of every bucket once, on this rank's inputs
    (not a metric): GB/s a rank, as `grad_sync_GBps` counts them."""
    rank = dist.get_rank()
    flats = [bucket_inputs(ctx.seed, i, b, shapes, [rank], device, False,
                           flat=True) for i, b in enumerate(buckets)]
    dist.all_reduce(flats[0])
    sync(device)
    t0 = time.perf_counter()
    for f in flats:
        dist.all_reduce(f)
    sync(device)
    seconds = time.perf_counter() - t0
    gb = sum(f.numel() for f in flats) * 4 / 1e9
    return (f"yardstick nccl_all_reduce: {gb / seconds!r} GB/s a rank over "
            f"{len(flats)} buckets ({gb!r} GB a rank, {seconds!r} s)")


def _merge(parts: List[dict], ctx: RunContext) -> RunResult:
    """Rank 0's result from every process's part: the longest window, the
    fullest card, the worst check, the devices' traces averaged."""
    tr = ctx.cell.traffic
    first = parts[0]
    window = max(p["window"] for p in parts)
    checks = {k: max(p["checks"][k] for p in parts) for k in first["checks"]}
    limits = tr["limits"]
    summaries = [p["summary"] for p in parts if p["summary"] is not None]
    elems = first["elems"]
    wire = WIRE[tr["wire_dtype"]]
    return RunResult(
        attempted=first["calls"], failed=0,
        end_to_end={"grad_sync_GBps": elems * 4 / window / 1e9,
                    "setup_s": first["setup_s"]},
        counters={"buckets": first["calls"], "elements": elems,
                  "ranks": tr["ranks"], "stacked": tr["comm"] == "stacked",
                  "devices": len(parts),
                  "wire_bytes": 4 if wire is None else 2},
        checks={k: (v, float(limits[k])) for k, v in checks.items()},
        memory_peak_bytes=max(p["memory"] for p in parts),
        window_s=window,
        trace=mean_summary(summaries) if summaries else None,
        lines=[line for p in parts for line in p["lines"]])
