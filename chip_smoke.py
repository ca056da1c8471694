#!/usr/bin/env python3
"""Drives the PyTorch port (src/repro_torch) on one CUDA card and checks it.

    python3 chip_smoke.py [--seed N]

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device           CUDA required; TF32 off; the card's name and power limit.
2. build            nvcc builds every kernel from src/repro_torch/kernels/csrc,
                    one nvcc per source, all started together; for the
                    tensor-core kernels (flash_attention, ssd_chunk,
                    ssd_state):
                    registers and spills of each bf16 instance, ptxas's
                    notes on wgmma, and the HGMMA (wgmma) instructions in
                    the library's SASS (`cuobjdump -sass` beside nvcc): a
                    count of 0 fails the phase.
3. kernel_vs_plain  the flash kernel against its plain PyTorch version on the
                    card over dtypes, head dims, head groupings, masks and
                    ragged lengths, including the tensor-core path's tile
                    edges; times at the serving shape (device time per call
                    from a CUDA graph, and eager) beside the bound, TFLOP/s,
                    the plain version and one PyTorch library call.
4. chunk_accum_vs_plain
                    the chunk_accum kernel, dense and indexed, f32/bf16/f16
                    updates, ragged widths, widths 1-8 with repeated trash
                    rows: torch.equal to its plain version; times at the
                    widest reduce-scatter call of a 64 MiB gradient bucket,
                    rotating over rows well beyond L2 (device time per call
                    from a CUDA graph's replay, and the eager time per call
                    with the host's cost).
5. model_vs_cpu     reduced qwen3-8b and gemma2-2b, the same weights on the
                    card (kernel path) and on the CPU (plain path): prefill and
                    decode logits agree.
6. serve            serving path: qwen3-8b at full width (36 layers,
                    d_model 4096, bf16, random weights from --seed) serves 4
                    long, ragged prompts through ServingEngine; the flash
                    kernel is launched once per layer per batch.
7. entry_point      `python -m repro_torch.launch.serve --arch qwen3-8b
                    --reduced` with no --device flag exits 0.
8. collectives_stacked
                    training's gradient path: 8 data-parallel ranks stacked
                    on the card run BucketedAllReduce over gemma2-2b's full
                    gradient (2.61 B f32 per rank, 64 MiB buckets, one
                    bucket alive at a time) on the default data-axis model
                    (a bidirectional ring) and on dgx:8; every rank ends
                    equal, the reduce-scatter is bit-equal to the same
                    program with the plain accumulate, and the sum is within
                    STACK_ATOL of stack.sum(0).  chunk_accum is launched in
                    every reduce-scatter call.
9. train            `repro_torch.launch.train` trains gemma2-2b at full width
                    (bf16 compute, fp32 masters and AdamW) for 3 steps of
                    4 x 512 tokens on the card: finite losses, step time,
                    tokens/s, peak memory; attention under autograd takes
                    the plain path, so the flash kernel is not launched; the
                    supervisor's final checkpoint goes to a temporary
                    directory, deleted after the phase.
10. train_vs_cpu    reduced qwen3-8b and gemma2-2b, 2 train steps from the same
                    weights on the card and on the CPU: losses and params
                    agree.
11. train_entry_point
                    `python -m repro_torch.launch.train --arch qwen3-8b
                    --reduced --steps 2 --collectives pipeline` with no
                    --device flag exits 0 and ends with its `done at step 2;
                    stragglers: S; link faults repaired: False` line.
12. nccl_p2p        with two or more cards: the P2P form under NCCL at world =
                    the card count, bit-equal to the stacked form; with one
                    card it prints that it did not run.
13. ssd_vs_plain    the SSD intra-chunk kernel against its plain PyTorch
                    version on the card, y and states, f32 (CUDA cores) and
                    bf16 (tensor cores), chunks Q of 16, 48, 64, 100, 129,
                    256 and 512 with head dims P and state dims N from 16
                    to 128, and of 1, 1000 and 4096 rows at a few widths,
                    in the Pallas layout and in the model's (transposed
                    views, b and c shared by every head), and bf16 b, c
                    whose rows are off 16 bytes; the cases bit-equal to the
                    plain version, per dtype: every fp32 case must be,
                    except a chunk of one row, whose fp32 y must then equal
                    the kernel's documented order of adds (ssd_chunk.cu's
                    top comment), and each fp32 case that is not is printed
                    (`fp32_not_bit_equal`); errors and times at
                    mamba2-780m's and zamba2-1.2b's prefill shapes (device
                    time per call from a CUDA graph, and eager) beside the
                    bound and the plain version, rotating over inputs
                    beyond L2; and at mamba2-780m's shape on a model rank's
                    own 24, 12 and 3 heads (`local_heads`), as head-slice
                    views of a [B,S,48,P] tensor and in the placed mixer's
                    layout, b and c whole: each within the tolerances,
                    whether `dense_if_unaligned` copied x, b or c, and
                    device time per call beside the bound.
                    The chunked SSD's autograd Function (all four steps:
                    the block's kernels and the state passes', forward and
                    backward) against plain autograd of the same function
                    in float32 (`_ssd_chunked_plain`: rounded to bf16 where
                    the kernels round, the gradients passed through those
                    roundings unrounded) at the sweep's chunks and every
                    (P, N), and at mamba2-780m's prefill shape on 48, 24,
                    12 and 3 heads with and without an initial state, bf16
                    and float32 (`chunked`): every gradient within
                    SSD_BWD_TOL, bit-equal run to run; the block's
                    backward alone and the state passes (`state_train`,
                    `state_zamba2`) timed at the train shapes from CUDA
                    graphs over inputs beyond L2, beside their bounds and
                    the plain steps' forward and plain autograd.
14. ssm_model_vs_cpu
                    reduced mamba2-780m and zamba2-1.2b, the same weights on
                    the card (kernel path) and on the CPU (plain path):
                    prefill and decode logits agree; one SSD launch per
                    Mamba2 layer in prefill (and one flash launch per shared
                    attention site for zamba2).
15. serve_ssm       serving path of the ssm and hybrid families:
                    mamba2-780m (48 layers, d_model 1536) and zamba2-1.2b (38
                    Mamba2 layers, d_model 2048, shared attention every 6) at
                    full width, bf16, random weights from --seed, 4 prompts in
                    batches of 2 whose padded lengths are multiples of the
                    chunk; the SSD kernel is launched once per Mamba2 layer
                    per batch, the flash kernel once per zamba2 site.
16. ssm_entry_point `python -m repro_torch.launch.serve --arch mamba2-780m
                    --reduced --prompt-len 32` with no --device flag exits 0.
17. train_long      training's state at full width: `repro_torch.launch.train
                    --arch gemma2-2b --seq 4096 --global-batch 1 --steps 3
                    --ckpt-every 3` through `run()`: finite losses, step
                    time, tokens/s, peak memory, the blockwise attention
                    path in every layer of every forward and recomputation
                    (2 x 26 calls a step), AdamW's kernel (a norm and an
                    update launch a step, every element counted on its
                    path, none on the loop's); the free disk space before the
                    checkpoint is written, its bytes and the seconds of its
                    save (device to host, write), wait and restore; restored
                    into a fresh state on the host, every leaf equal to the
                    live state; the directory is deleted.
18. train_long_vs_cpu
                    reduced gemma2-2b and qwen3-8b, 2 train steps of 2304
                    rows from the same weights on the card and on the CPU,
                    both through the blockwise path: losses and params
                    agree (TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL).
19. supervisor_restore
                    reduced qwen3-8b on the card under TrainSupervisor, a
                    checkpoint every 3 steps and a step_fn that raises once
                    after step 4: the replayed steps 3-5 match the first
                    pass's steps 3 and 4 and an unbroken run's within
                    RESTORE_RTOL.
20. schedule_cache  for dgx:8 and data-ring8, the `repro.allreduce` artifact
                    compiled cold into a fresh cache, then loaded by a new
                    `Collectives(cache=...)`: compile and hit seconds, the
                    reloaded payload byte-identical, and one 64 MiB bucket
                    of 8 stacked ranks reduced through the reloaded program
                    torch.equal to the cold one (chunk_accum launched).
21. repair_stacked  the paper's online repair on the card: a
                    CollectiveContext over data-ring8 with stacked ranks
                    reduces one 64 MiB bucket, `hot_swap("@fail(0-1)")`,
                    rebuilds the hook and reduces again: torch.equal to a
                    context built cold on the degraded ring, within
                    STACK_ATOL of stack.sum(0); each RepairReport's wall
                    time and warm flags, and the repaired program's
                    chunk_accum launches.

22. moe_model_vs_cpu
                    reduced qwen2-moe-a2.7b (1 shared expert) and
                    mixtral-8x7b, the same weights on the card and on the
                    CPU: prefill and decode logits agree, one flash launch
                    per layer in prefill.
23. serve_moe       serving path of the moe family: qwen2-moe-a2.7b at full
                    width (24 layers, d_model 2048, 60 experts top-4 and 4
                    shared, ~14.3 B params, bf16) serves the serve phase's
                    prompts (1000, 613, 1024, 96; batch 2, 16 new tokens):
                    well-formed completions, one flash launch per layer per
                    batch, finite logits; prefill positions/s, decode
                    tokens/s, peak memory, routed choices dropped by
                    capacity in prefill and decode (a count), and eager
                    launches per decoded token (torch.profiler).  Then
                    mixtral-8x7b at full width with 4 of its 32 layers (its
                    93 GB of bf16 weights do not fit), stated in `reduced`.
24. moe_entry_point `python -m repro_torch.launch.serve --arch
                    qwen2-moe-a2.7b --reduced` with no --device flag exits 0.
25. alltoall_stacked
                    tree_all_to_all on bring:4, bring:8, fig1a and dgx:8
                    torch.equal to the stacked transpose (f32, bf16); one
                    full-width MoE layer of qwen2-moe-a2.7b over 4 stacked
                    ranks and of mixtral-8x7b over 8, 2 x 512 tokens per
                    rank, through the context's alltoall program: the tree
                    transport bit-equal to the transpose in bf16, and in
                    fp32 within MOE_ATOL of each rank's dense dispatch;
                    ms per call of both transports on the dispatch buffer.
26. rooted_stacked  64 MiB per rank over the data axis's 8 stacked ranks,
                    roots 0 and 3: tree_broadcast torch.equal to the root's
                    buffer on every rank; tree_reduce on the root bit-equal
                    to the same program with the plain accumulate and within
                    STACK_ATOL of stack.sum(0); seconds per call and the
                    chunk_accum launches.

27. families_vs_cpu
                    reduced paligemma-3b and whisper-medium, the same
                    weights and stub frontend embeddings on the card and on
                    the CPU: prefill and 4 decode logits agree; flash is
                    launched once per attention call of the prefill (the
                    prefix-LM mask; the encoder's and the cross-attention's
                    non-causal masks, Sq != Skv).
28. serve_vlm       paligemma-3b at full width (18 layers, d_model 2048, 8
                    heads over 1 kv head of 256, vocab 257216, ~2.51 B
                    params, bf16): 4 requests of 256 patch embeddings and
                    512, 300, 512, 64 text tokens, batch 2, 16 new tokens;
                    prefill positions/s (patch rows counted), decode
                    tokens/s, peak memory, eager launches per decoded token;
                    flash once per layer per batch (36).
29. serve_audio     whisper-medium at full width (24 + 24 layers, d_model
                    1024, 16 heads of 64, vocab 51865, ~0.76 B params,
                    bf16): 4 requests of 1500 frames and decoder prompts of
                    128, 64, 200, 16 tokens, batch 2, 16 new tokens; the
                    same numbers and the encoder's seconds apart from the
                    decoder's prefill; flash 72 times per batch (encoder,
                    decoder self- and cross-attention; 144), decode on the
                    direct path.
30. train_families  `repro_torch.launch.train` 3 steps each, bf16 compute,
                    fp32 masters, AdamW, remat: mamba2-780m at 2 x 4096 and
                    zamba2-1.2b at 2 x 1024, paligemma-3b at 2 x (256 + 512), whisper-
                    medium at 2 x (1500 + 448), all uncut, and
                    qwen2-moe-a2.7b at full width with 4 of 24 layers
                    (stated in `reduced`): finite losses, the MoE aux term
                    (total - token loss), step seconds, tokens/s, peak
                    memory; attention under autograd takes its plain
                    path, the chunked SSD its kernels: per Mamba2 layer a
                    step, the block's and the state passes' forward twice
                    (remat) and their backward once (mamba2-780m: 96 / 48
                    each; zamba2-1.2b 76 / 38), and no plain
                    version of any of the SSD's four steps runs; AdamW's
                    kernel a norm and an update launch a step, every
                    element counted on its path, none on the loop's.  The
                    supervisor's checkpoint writes are recorded, not made
                    (phases 9 and 17 measure them).
31. train_families_vs_cpu
                    reduced configs of the five families, 2 train steps
                    from the same weights on the card and on the CPU:
                    losses and params agree (TRAIN_LOSS_RTOL,
                    TRAIN_PARAM_ATOL).
32. families_entry_point
                    `python -m repro_torch.launch.serve --arch paligemma-3b
                    --reduced` (and whisper-medium) and `python -m
                    repro_torch.launch.train --arch <a> --reduced --steps 2`
                    for the five families, with no --device flag, started
                    together: each exits 0.

33. model_parallel_mesh1
                    the model axis on one card: NCCL at world 1 and a 1 x 1
                    ("data", "model") mesh.  qwen3-8b at full width served
                    through `launch.serve.serve` on serve's prompts with
                    its params placed by `serving_param_specs` as DTensors,
                    beside the plain path: greedy tokens equal, first-step
                    logits torch.equal (else within MESH1_LOGITS_ATOL, the
                    difference printed), flash 36 launches per prefill on
                    local tensors, prefill positions/s and decode tokens/s
                    of both; the same for mamba2-780m (2 x 512 tokens) and
                    zamba2-1.2b (2 x 256), 8 new tokens, through the placed
                    Mamba2 mixer: the SSD kernel and the state passes' 48
                    and 38 launches per prefill, flash 6 for zamba2; the
                    mamba2 step launches the SSD's forward kernels 96 and
                    its backward kernels 48 times on both paths;
                    gemma2-2b's two train steps
                    and one mamba2-780m step of 2 x 512 through
                    `launch.train.run` on the mesh (FSDP+TP placements)
                    against the plain launch on AdamW's loop within
                    TRAIN_LOSS_RTOL, no AdamW kernel launch on either; the
                    plain launch on AdamW's kernel beside them: a norm and
                    an update launch a step, every element through it, the
                    first loss equal to the loop leg's, the first norm no
                    farther from its float64 norm than half an ulp, every
                    norm within ADAMW_NORM_RTOL of float64, and every 4th
                    tensor's p, mu, nu torch.equal to the loop from the
                    kernel's scale at every step; the
                    per-rank bytes of mixtral-8x7b's serving at TP 2 and 4
                    and qwen3-8b's training state at (2, 2), reckoned on the
                    meta device.
34. model_parallel_cards
                    with two or more cards: mixtral-8x7b at its full 32
                    layers served over every card (`--model-parallel N`,
                    the params from model rank 0 by the tree broadcast; with
                    more than two cards again with `--inject-fault 0-1`),
                    mamba2-780m served over every card, and `launch.train
                    --arch qwen3-8b --model-parallel 2 --data-parallel N/2
                    --steps 3` and zamba2-1.2b's 2 steps the same way;
                    requests served, finite losses, tokens/s, step seconds
                    and peak memory per card.  With one card it prints that
                    it did not run.

35. dryrun_cards    `repro_torch.launch.dryrun`'s main with fake CUDA
                    tensors (its default --device cuda), one process per
                    cell started together: qwen3-8b train_4k and
                    prefill_32k on the fake 16x16 mesh, mixtral-8x7b
                    decode_32k on 2x16x16, gemma2-2b long_500k (the
                    reference's skip), mamba2-780m prefill_32k on 16x16
                    (the SSD op's fake CUDA path on 3 heads a rank),
                    zamba2-1.2b train_4k on 2x16x16 and qwen3-8b
                    decode_32k on 16x16 (its cache split on head_dim:
                    scores all-reduced, the cache never gathered): each
                    line OK (or SKIP), exit 0, no kernel launched; each
                    cell's per-device counts, memory and roofline row,
                    and the card's total memory beside
                    `H100_SXM.hbm_bytes`.
36. roofline_measured
                    `analysis.hlo_count` around real steps on the card:
                    qwen3-8b's prefill of 2 x 1024 tokens at full width
                    (flash 36 launches a prefill) and gemma2-2b's train
                    step of phase 9 (4 x 512, bf16 compute, fp32 masters,
                    AdamW, remat): the counted per-device FLOPs and
                    bytes, the `RooflineTerms` bound against `H100_SXM`,
                    the wall seconds (median of timed calls) and the
                    device-busy seconds (bench/trace.py's reduction of
                    a torch.profiler trace), and the MFU,
                    model FLOPs / (seconds x peak bf16 FLOP/s).
37. examples        examples/{quickstart,schedule_explorer,serve_lm,
                    train_lm}_torch.py at their documented flags on the
                    card (no --device: the default), each in its own
                    process, started together: exit 0, quickstart's and
                    schedule_explorer's programs run on stacked ranks
                    (chunk_accum launches > 0 for quickstart), serve_lm's
                    6 requests, train_lm's 200 steps; each one's seconds.
38. adamw          the optimizer's multi-tensor kernel (kernels/adamw.py,
                    csrc/adamw.cu) against its loop (`optimizer._loop`),
                    from the kernel's own clip scale, over 3 steps (the
                    gradients drawn at scales 1, 1e-5 and 1e-3: clipped,
                    not, clipped) on mamba2-780m's 434 float32 masters from
                    `init_train_state` and on odd sizes (1, 3, 7, 4097,
                    2^20 + 5 elements, 1-D and 2-D; once 16-byte aligned
                    and once 4 bytes off, the scalar path) and on one
                    real train step's gradients (mamba2-780m, bf16, remat,
                    2 x 1024; the kernel launched with no sync after the
                    backward pass): p, mu and nu torch.equal; the kernel's norm within ADAMW_NORM_RTOL of
                    a float64 sum and no farther from it than
                    `global_norm`; launches a step (<= 3); 3 steps through
                    `adamw_update` (the counter, host ms a call); device ms
                    a step from a CUDA graph beside the bytes bound and the
                    loop's (norm, clamp and loop) in the same process.

Phase 3 also holds flash against its plain version at the serving shapes
of the vlm and audio families (FAMILY_FLASH) and times them, and gives
the host microseconds per call of flash through its custom op against the
bare ctypes launch (`host_cost`).  The card's peaks (PEAK_*) are
`repro_torch.topo.hardware.H100_SXM`'s.

Then the card's line from nvidia-smi, a `kernels` JSON line (each kernel's
launches on its main path, and per path of the later slices), and as the
last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import datetime
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.topo.hardware import H100_SXM  # noqa: E402

PEAK_BF16_FLOPS = H100_SXM.peak_flops_bf16   # dense bf16 tensor cores
PEAK_F32_FLOPS = H100_SXM.peak_flops_f32     # fp32 outside the tensor cores
PEAK_BYTES = H100_SXM.hbm_bw                 # HBM3
TOL = {torch.float32: 1e-4,   # accumulation order
       torch.bfloat16: 2e-2}  # the output's rounding
MODEL_ATOL = 1e-4             # fp32 logits, kernel vs plain attention
# SSD block, kernel vs plain on the same inputs: f32 differs in the order of
# the sums; with bf16 inputs both compute in f32 and y differs by one bf16
# rounding (no looser than tests/test_kernels.py's atol 0.35, rtol 0.1);
# states are f32 in both
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
SSD_TOL_BF16_Y = dict(atol=1e-3, rtol=2.0 ** -7)
# SSD backward, kernel vs plain autograd on the same inputs: each gradient's
# largest error over its largest magnitude.  fp32 sums in another order
# (cuBLAS against the kernel's FMA chains, over up to a chunk's rows and
# the heads); bf16 carries its float32 operands in two bf16 parts (~2**-16)
# and rounds dx, db, dc to bf16 once (2**-9 of each element).  da is a sum
# over every row of reverse cumsums of dcum, whose parts (the rows and
# columns of dM o M) cancel, and the two sides' dM o M differ in the order
# of their float32 sums, so da keeps ~1e-4 of its size (up to 2.7e-4 read
# in float32 on an H100)
SSD_BWD_TOL = {
    torch.float32: dict(dx=1e-5, ddt=1e-5, da=1e-3, db=1e-5, dc=1e-5),
    torch.bfloat16: dict(dx=2.0 ** -7, ddt=1e-4, da=1e-3, db=2.0 ** -7,
                         dc=2.0 ** -7)}
# mamba2-780m's train step (the benchmark's cell): 2 x 4096 tokens, chunk
# 512; and zamba2-1.2b's Mamba2 layers at the same length
SSD_TRAIN = dict(b=2, s=4096, h=48, p=64, n=128, q=512)
SSD_TRAIN_ZAMBA2 = dict(b=2, s=4096, h=64, p=64, n=64, q=256)
# mamba2-780m prefill: 2 prompts of 2048 tokens, 48 heads of 64, state 128
SSD_MAIN = dict(b=2, s=2048, h=48, p=64, n=128, q=512)
# zamba2-1.2b prefill: 2 prompts of 1024 tokens, 64 heads of 64, state 64
SSD_ZAMBA2 = dict(b=2, s=1024, h=64, p=64, n=64, q=256)
MAIN = dict(b=2, h=32, hkv=8, s=1024, d=128)   # qwen3-8b prefill attention
GRAPH_CALLS = 10              # flash calls per captured graph (phase 3)
# flash at the serving shapes of the vlm and audio families (phase 3):
# paligemma-3b's prefill (256 patches + 512 text rows, prefix-LM, MQA, head
# dim 256), whisper-medium's encoder (1500 frames, non-causal) and its
# cross-attention (200 decoder rows over 1500 encoder rows)
FAMILY_FLASH = [((2, 8, 1, 768, 768, 256), dict(causal=True, prefix_len=256)),
                ((2, 16, 16, 1500, 1500, 64), dict(causal=False)),
                ((2, 16, 16, 200, 1500, 64), dict(causal=False))]
DEV = "cuda"
RANKS = 8                     # data-parallel ranks stacked on the card
TRAIN_ARGV = ["--arch", "gemma2-2b", "--steps", "3", "--global-batch", "4",
              "--seq", "512"]
# |allreduce - stack.sum(0)| for N(0,1) data over 8 ranks: two f32 sums of
# 8 terms in different orders differ by at most 14 roundings of 2**-24 times
# the largest partial sum, which stays below ~50 for 2e10 draws
STACK_ATOL = 1e-4
TRAIN_LOSS_RTOL = 1e-5        # fp32 losses, card vs CPU (summation order)
# fp32 params after 2 AdamW steps, card vs CPU: where a gradient is ~eps an
# update can flip sign, so the bound is two steps of lr (<= 2e-4) each way
TRAIN_PARAM_ATOL = 1e-3
TRAIN_LONG_ARGV = ["--arch", "gemma2-2b", "--seq", "4096", "--global-batch",
                   "1", "--steps", "3", "--ckpt-every", "3"]
# losses of a step replayed after a restore against the first pass and an
# unbroken run, on the card: the embedding's backward adds with atomics, so
# two CUDA runs of one step may differ in the last bit
RESTORE_RTOL = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, iters: int = 10) -> float:
    """Device time of one of the `calls` calls that fn makes: fn captured in
    a CUDA graph and replayed, so the host's per-call cost drops out."""
    fn()                                    # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=iters) / calls


def phase_device() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi.splitlines()[0]


def _ptxas_by_kernel(log: str) -> dict:
    """kernel (mangled name) -> {"registers": n, "spill": [stores, loads]}
    from nvcc's -Xptxas -v log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _hgmma_count(library: str) -> dict:
    """HGMMA (wgmma) instructions in a built library's SASS, from the
    toolkit's cuobjdump beside nvcc, by function (mangled name)."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts.setdefault(fn, 0)
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


# the tensor-core kernels: library -> the mangled names of its bf16
# instances, and how their template arguments read
WGMMA_INSTANCES = {
    "flash_attention": [(r"flash_fwd_bf16ILi(\d+)E", "D={}")],
    "ssd_chunk": [(r"ssd_chunk_bf16ILi(\d+)ELi(\d+)E", "P={},N={}"),
                  (r"ssd_bwd_dx_bf16ILi(\d+)ELi(\d+)E", "bwd_dx P={},N={}"),
                  (r"ssd_bwd_ds_bf16ILi(\d+)ELi(\d+)E", "bwd_ds P={},N={}")],
    "ssd_state": [(r"ssd_readout_bf16ILi(\d+)ELi(\d+)E", "readout P={},N={}"),
                  (r"ssd_state_grads_bf16ILi(\d+)ELi(\d+)E",
                   "grads P={},N={}")]}


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    names = ("flash_attention", "chunk_accum", "ssd_chunk", "ssd_state",
             "adamw")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        built = list(pool.map(lambda n: build.build(n, force=True), names))
    seconds = time.perf_counter() - t0
    for name, (path, log) in zip(names, built):
        spills = [l.strip() for l in log.splitlines() if "spill" in l
                  and not l.strip().startswith("0 bytes stack frame, 0 bytes")]
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  log)})
        extra = {}
        if name in WGMMA_INSTANCES:
            # the bf16 paths run on the tensor cores: every bf16 instance's
            # SASS holds HGMMA
            by_fn = _hgmma_count(str(path))
            ptxas = _ptxas_by_kernel(log)
            instances = {}
            for pattern, label in WGMMA_INSTANCES[name]:
                for kernel in set(ptxas) | set(by_fn):
                    m = re.search(pattern, kernel)
                    if m:
                        instances[label.format(*m.groups())] = dict(
                            ptxas.get(kernel, {}), hgmma=by_fn.get(kernel, 0))
            assert instances and all(v["hgmma"] > 0 for v in
                                     instances.values()), (name, instances)
            # ptxas names the wgmma it had to serialize (a lost overlap)
            notes = [l.strip() for l in log.splitlines()
                     if "wgmma" in l.lower()]
            extra = dict(hgmma=sum(by_fn.values()), bf16_instances=instances,
                         ptxas_wgmma_notes=notes)
        emit("build", kernel=name,
             source=f"src/repro_torch/kernels/csrc/{name}.cu",
             library=os.path.relpath(path, ROOT), seconds_all=seconds,
             registers=regs, nonzero_spill_lines=spills, **extra)


def _qkv(gen, b, h, hkv, sq, skv, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(b, h, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)


def _flash_cases() -> list:
    """(shape (B, H, Hkv, Sq, Skv, D), mask) of phase 3: dtypes are added by
    the caller."""
    shapes = [(1, 4, 4, 256, 256, 64),       # MHA
              (2, 8, 2, 1000, 1000, 128),    # GQA, ragged
              (1, 8, 1, 77, 77, 256),        # MQA, ragged, gemma-size head
              (1, 4, 2, 200, 77, 64),        # Sq > Skv: rows fully masked
              (1, 4, 2, 77, 200, 128),       # Sq < Skv
              (1, 2, 2, 128, 128, 16),
              (2, 4, 2, 256, 256, 32)]
    masks = [dict(causal=True), dict(causal=False),
             dict(causal=True, window=64), dict(causal=True, prefix_len=32),
             dict(causal=True, logit_cap=50.0),
             dict(causal=True, window=96, logit_cap=30.0)]
    cases = [(shape, mask) for shape in shapes for mask in masks]
    # the tensor-core path's tile edges (q tiles of 64 rows, 128 at D = 256;
    # kv tiles of 64): lengths 2, 127, 129, 191 on both axes, a window
    # smaller than a tile, a prefix longer than Sq
    for sq, skv in [(2, 2), (127, 127), (129, 129), (191, 191), (2, 191),
                    (191, 2), (127, 129), (129, 127)]:
        for mask in (dict(causal=True), dict(causal=False),
                     dict(causal=True, window=8),
                     dict(causal=True, prefix_len=sq + 5)):
            cases.append(((1, 4, 2, sq, skv, 128), mask))
    # head groupings 1, 4 and 8 at the serving head dims
    for d in (64, 128, 256):
        for group in (1, 4, 8):
            for mask in (dict(causal=True), dict(causal=True, window=8)):
                cases.append(((1, 8, 8 // group, 191, 191, d), mask))
    return cases


def phase_kernel_vs_plain(seed: int) -> dict:
    from repro_torch.kernels import flash_attention, mha_reference
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = MAIN
    main_cases = [((m["b"], m["h"], m["hkv"], s, s, m["d"]), dtype)
                  for s in (1024, 1000)
                  for dtype in (torch.bfloat16, torch.float32)]
    cases = [(shape, dtype, mask) for shape, mask in _flash_cases()
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, dtype, dict(causal=True)) for shape, dtype in main_cases]
    cases += [(shape, dtype, mask) for shape, mask in FAMILY_FLASH
              for dtype in (torch.float32, torch.bfloat16)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    main_err = 0.0
    failures = []
    for shape, dtype, mask in cases:
        q, k, v = _qkv(gen, *shape, dtype)
        got = flash_attention(q, k, v, **mask)
        torch.cuda.synchronize()
        ref = mha_reference(q, k, v, **mask)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        err = (got.float() - ref.float()).abs().max().item()
        worst[dtype] = max(worst[dtype], err)
        if shape[3] == m["s"] and dtype == torch.bfloat16:
            main_err = max(main_err, err)
        if not err <= TOL[dtype]:
            failures.append((shape, str(dtype), mask, err))
    assert not failures, f"kernel disagrees with its plain version: {failures}"

    # times at the serving shape: prefill attention of qwen3-8b, S = 1024.
    # Device time per call from a CUDA graph of GRAPH_CALLS calls (the
    # wrapper's host cost drops out), and the eager time, which has it.
    q, k, v = _qkv(gen, m["b"], m["h"], m["hkv"], m["s"], m["s"], m["d"],
                   torch.bfloat16)

    def kernel():
        for _ in range(GRAPH_CALLS):
            flash_attention(q, k, v, causal=True)

    def library():
        for _ in range(GRAPH_CALLS):
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)

    plain_ms = cuda_ms(lambda: mha_reference(q, k, v, causal=True))
    kernel_ms = graph_ms(kernel, GRAPH_CALLS)
    library_ms = graph_ms(library, GRAPH_CALLS)
    eager_ms = cuda_ms(kernel, iters=5) / GRAPH_CALLS
    library_eager_ms = cuda_ms(library, iters=5) / GRAPH_CALLS
    kernel_ms = (kernel_ms + graph_ms(kernel, GRAPH_CALLS)) / 2
    library_ms = (library_ms + graph_ms(library, GRAPH_CALLS)) / 2
    plain_ms = (plain_ms + cuda_ms(
        lambda: mha_reference(q, k, v, causal=True))) / 2
    # causal: half the score matrix; two products of 2*D flops per entry
    flops = 4 * m["b"] * m["h"] * m["s"] * m["s"] * m["d"] / 2
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    bound_by = max(bound, key=bound.get)
    res = dict(cases=len(cases), max_abs_err_f32=worst[torch.float32],
               max_abs_err_bf16=worst[torch.bfloat16], tol_f32=TOL[torch.float32],
               tol_bf16=TOL[torch.bfloat16], main_shape=m, main_dtype="bfloat16",
               main_max_abs_err=main_err, kernel_ms=kernel_ms,
               kernel_eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_eager_ms=library_eager_ms,
               library="torch.nn.functional.scaled_dot_product_attention",
               timing=f"kernel_ms, library_ms: device time per call, CUDA "
                      f"graph of {GRAPH_CALLS} calls; *_eager_ms: eager calls",
               bound_ms=bound[bound_by], bound_by=bound_by, flops=flops,
               bytes=nbytes, tflops=flops / kernel_ms / 1e9,
               library_tflops=flops / library_ms / 1e9,
               bound_fraction=bound[bound_by] / kernel_ms,
               fp32_core_bound_ms=flops / PEAK_F32_FLOPS * 1e3)
    res["family_shapes"] = [_flash_time(gen, shape, mask)
                            for shape, mask in FAMILY_FLASH]
    res["host_cost"] = _flash_host_cost(q, k, v)
    emit("kernel_vs_plain", **res)
    return res


def _flash_host_cost(q, k, v, calls: int = 50) -> dict:
    """Host microseconds per call to enqueue flash at the serving shape:
    `flash_attention` as serving calls it (checks, the output's
    allocation, the launch plan, the ctypes call), the custom op
    `repro_torch::flash_attention` that a dispatch mode (fake tensors, the
    counter) goes through, and the bare ctypes call with its arguments
    ready.  The device time per call (~0.065 ms) exceeds each, so the loop
    measures the host alone; turns alternate, twice."""
    from repro_torch.kernels.flash_attention import (KERNEL, flash_attention,
                                                     launch_args)
    out = torch.empty_like(q)
    args = launch_args(q, k, v, out, causal=True, window=None, prefix_len=0,
                       logit_cap=None)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"wrapper": lambda: flash_attention(q, k, v, causal=True),
           "op": lambda: torch.ops.repro_torch.flash_attention(
               q, k, v, True, 0, 0, 0.0),
           "bare": lambda: KERNEL.launch(*args, stream)}
    us = {name: [] for name in fns}
    for name in ("wrapper", "op", "bare", "bare", "op", "wrapper") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        us[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    best = {name: min(v) for name, v in us.items()}
    return dict(calls=calls, us=us, us_min=best,
                wrapper_extra_us=best["wrapper"] - best["bare"],
                op_extra_us=best["op"] - best["bare"])


def _allowed_entries(sq: int, skv: int, causal: bool, prefix_len: int = 0
                     ) -> int:
    """Score entries a mask lets through (the kernel skips the others):
    query row i sees kv rows j <= i, or every row when not causal, and
    every row j < prefix_len."""
    if not causal:
        return sq * skv
    i = np.arange(sq)
    return int(np.maximum(np.minimum(i + 1, skv),
                          min(prefix_len, skv)).sum())


def _flash_time(gen, shape, mask: dict) -> dict:
    """bf16 device time per call (CUDA graph) at a serving shape of the
    vlm and audio families, beside its bound, its plain version and SDPA
    (for a prefix mask SDPA takes a boolean mask: a yardstick only)."""
    from repro_torch.kernels import flash_attention, mha_reference
    b, h, hkv, sq, skv, d = shape
    q, k, v = _qkv(gen, *shape, torch.bfloat16)
    prefix = mask.get("prefix_len", 0)
    sdpa_kw = dict(enable_gqa=True)
    if prefix:
        i, j = torch.arange(sq, device="cuda"), torch.arange(skv,
                                                             device="cuda")
        sdpa_kw["attn_mask"] = (j[None] <= i[:, None]) | (j[None] < prefix)
    else:
        sdpa_kw["is_causal"] = mask["causal"]

    def kernel():
        for _ in range(GRAPH_CALLS):
            flash_attention(q, k, v, **mask)

    def library():
        for _ in range(GRAPH_CALLS):
            torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                             **sdpa_kw)
    err = (flash_attention(q, k, v, **mask).float()
           - mha_reference(q, k, v, **mask).float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], (shape, mask, err)
    kernel_ms = graph_ms(kernel, GRAPH_CALLS)
    library_ms = graph_ms(library, GRAPH_CALLS)
    plain_ms = cuda_ms(lambda: mha_reference(q, k, v, **mask), iters=5)
    flops = 4 * b * h * d * _allowed_entries(sq, skv, mask["causal"], prefix)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    bound_by = max(bound, key=bound.get)
    return dict(shape=list(shape), mask=mask, dtype="bfloat16",
                max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound[bound_by],
                bound_by=bound_by, flops=flops, bytes=nbytes,
                tflops=flops / kernel_ms / 1e9)


def _bucket_call(prog, bucket_bytes: int):
    """(rows, chunk) of a stacked reduce-scatter buffer for one bucket, and
    the (read, write) rows of the program's widest call."""
    elems = bucket_bytes // 4                       # f32 gradients
    a, s = prog.axis_size, prog.slots_per_shard
    shard = -(-elems // a)                          # ceil
    ce = -(-shard // s)
    call = max((c for rnd in prog.rounds for c in rnd),
               key=lambda c: len(c.perm) * c.width)
    src = np.array([p[0] for p in call.perm])
    dst = np.array([p[1] for p in call.perm])
    rows = a * s + 1
    read = (src[:, None] * rows + call.send_slots[src]).ravel()
    write = (dst[:, None] * rows + call.recv_slots[dst]).ravel()
    return a * rows, ce, read, write


def phase_chunk_accum_vs_plain(seed: int) -> dict:
    from repro_torch.api import Collectives
    from repro_torch.kernels import (chunk_accum, chunk_accum_indexed,
                                     chunk_accum_indexed_reference,
                                     chunk_accum_reference)
    from repro_torch.topo import axis_topology_for_mesh
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    cases, failures = 0, []
    for dtype in dtypes:
        for n, c in ((1, 1), (3, 5), (8, 512), (7, 1003), (16, 131072),
                     (5, 3085), (64, 2048)):
            acc, upd = rnd(n, c), rnd(n, c, dtype=dtype)
            got = chunk_accum(acc.clone(), upd)
            torch.cuda.synchronize()
            cases += 1
            if not torch.equal(got, chunk_accum_reference(acc.clone(), upd)):
                failures.append(("dense", str(dtype), n, c))
        for width in range(1, 9):
            for c in (1, 7, 1003, 3084, 131072):
                rows = 8 * width + 1
                trash = rows - 1
                acc = rnd(rows, c)
                idx = torch.randperm(trash, generator=gen,
                                     device=DEV)[:width]
                # a non-receiver's slots are all the trash row
                idx = torch.cat([idx, torch.full((width,), trash,
                                                 device=DEV)])
                upd = rnd(2 * width, c, dtype=dtype)
                got = chunk_accum_indexed(acc.clone(), idx, upd, trash)
                torch.cuda.synchronize()
                cases += 1
                ref = chunk_accum_indexed_reference(acc.clone(), idx, upd,
                                                    trash)
                if not torch.equal(got, ref):
                    failures.append(("indexed", str(dtype), width, c))
    assert not failures, f"chunk_accum disagrees with its plain version: " \
        f"{failures}"

    # times at the widest reduce-scatter call of one 64 MiB bucket of the
    # stacked data-axis allreduce (the collectives phase's shapes)
    rs, _ = Collectives().program(axis_topology_for_mesh("data", RANKS),
                                  kind="allreduce")
    nrows, ce, _, write = _bucket_call(rs, 64 << 20)
    skip = rs.num_slots
    buf = rnd(nrows, ce)
    # SETS calls of the call's shape, each on rows of its own (~320 MB in
    # all, well above the 50 MB L2): the main path finds its rows cold
    sets = 40
    rows = torch.tensor([r for r in range(nrows) if r != skip])
    rows = rows[torch.randperm(len(rows))[:sets * len(write)]]
    idxs = rows.view(sets, len(write)).to(DEV)
    gots = rnd(sets, len(write), ce)

    def kernel():
        for idx, got in zip(idxs, gots):
            chunk_accum_indexed(buf, idx, got, skip)

    def plain():
        for idx, got in zip(idxs, gots):
            chunk_accum_indexed_reference(buf, idx, got, skip)

    def library():
        for idx, got in zip(idxs, gots):
            buf.index_add_(0, idx, got)

    # device time per call (graph replay) for the kernel and the library
    # call; the plain version syncs (boolean mask), so it runs eagerly; the
    # eager times include the host's cost per call, as the main path pays it
    plain_ms = cuda_ms(plain, iters=3) / sets
    kernel_ms = graph_ms(kernel, sets)
    library_ms = graph_ms(library, sets)
    eager_ms = cuda_ms(kernel, iters=3) / sets
    library_eager_ms = cuda_ms(library, iters=3) / sets
    kernel_ms = (kernel_ms + graph_ms(kernel, sets)) / 2
    plain_ms = (plain_ms + cuda_ms(plain, iters=3) / sets) / 2
    # one call: each landed element's acc read + acc written (4 + 4), the
    # update (4), and the call's row indices (8 each)
    nbytes = gots[0].numel() * 12 + idxs[0].numel() * 8
    res = dict(cases=cases, max_abs_err=0.0, equal=True,
               call_rows=len(write), call_cols=ce, buffer_rows=nrows,
               update_dtype="float32", kernel_ms=kernel_ms,
               kernel_eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_eager_ms=library_eager_ms,
               library="Tensor.index_add_", bytes=nbytes,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               flops=gots[0].numel(), timed_sets=sets)
    emit("chunk_accum_vs_plain", **res)
    return res


def phase_model_vs_cpu(seed: int,
                       names=("qwen3-8b", "gemma2-2b"),
                       phase: str = "model_vs_cpu") -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import FLASH_KERNEL
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    for name in names:
        cfg = reduced_config(name)
        model = build_model(cfg)
        cpu = model.init(seed, torch.float32, "cpu")
        gpu = copy.deepcopy(cpu).to(DEV)
        rng = np.random.default_rng(seed)
        b, s, max_len = 2, 77, 96
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int64))
        before = FLASH_KERNEL.launches
        worst = 0.0
        with torch.inference_mode():
            cc, lc = tf.lm_prefill(cpu, cfg, tokens,
                                   tf.init_kv_caches(cfg, b, max_len,
                                                     device="cpu"))
            cg, lg = tf.lm_prefill(gpu, cfg, tokens.to(DEV),
                                   tf.init_kv_caches(cfg, b, max_len,
                                                     device=DEV))
            launched = FLASH_KERNEL.launches - before
            for index in range(s, s + 4):
                worst = max(worst, (lg.cpu() - lc).abs().max().item())
                tok = lc[:, -1].argmax(-1)[:, None]
                lc, cc = tf.lm_decode_step(cpu, cfg, tok, cc, index)
                lg, cg = tf.lm_decode_step(gpu, cfg, tok.to(DEV), cg, index)
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
        assert torch.isfinite(lg).all()
        assert launched == cfg.num_layers, (name, launched)
        assert worst <= MODEL_ATOL, (name, worst)
        emit(phase, arch=name, reduced=True, prompt=[b, s],
             decode_steps=4, max_abs_logit_err=worst, atol=MODEL_ATOL,
             flash_launches_in_prefill=launched)


def phase_serve(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_KERNEL
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine
    cfg = get_config("qwen3-8b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    new_tokens, plens, batch_size = 16, (1000, 613, 1024, 96), 2
    engine = ServingEngine(model, params, batch_size=batch_size, max_len=2048)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
               for n in plens]
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    n_batches = -(-len(plens) // batch_size)

    FLASH_KERNEL.launches = 0
    t0 = time.perf_counter()
    outs = engine.run()
    wall_s = time.perf_counter() - t0
    launches = FLASH_KERNEL.launches

    assert [o.uid for o in outs] == list(range(len(plens)))
    for o, p in zip(outs, prompts):
        assert o.prompt_len == len(p)
        assert len(o.tokens) == len(p) + new_tokens
        assert (o.tokens[:len(p)] == p).all()
        new = o.tokens[len(p):]
        assert ((new >= 0) & (new < cfg.vocab_size)).all()
    assert launches == cfg.num_layers * n_batches, launches
    st = engine.stats
    res = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               dtype="bfloat16", params=n_params, init_s=init_s,
               prompts=list(plens), batch_size=batch_size,
               new_tokens=new_tokens, batches=n_batches, wall_s=wall_s,
               prefill_s=st["prefill_s"], decode_s=st["decode_s"],
               prefill_tokens=st["prefill_tokens"],
               decode_tokens=st["decode_tokens"],
               prefill_tok_per_s=st["prefill_tokens"] / st["prefill_s"],
               decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
               flash_launches=launches,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               completions=[[int(t) for t in o.tokens[o.prompt_len:]]
                            for o in outs])
    emit("serve", **res)
    return res


def phase_entry_point() -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b", "--reduced"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = [l for l in proc.stdout.splitlines() if l.startswith("req ")]
    assert len(served) == 6, proc.stdout
    emit("entry_point", command="python -m repro_torch.launch.serve --arch "
         "qwen3-8b --reduced", rc=proc.returncode, requests=len(served),
         seconds=time.perf_counter() - t0)


def _grad_shapes(name: str) -> dict:
    """name -> shape of every parameter (so every gradient) of the model at
    full width, from a module built on the meta device."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM
    with torch.device("meta"):
        lm = DecoderLM(get_config(name))
    return {n: tuple(p.shape) for n, p in lm.named_parameters()}


def phase_collectives_stacked(seed: int) -> dict:
    from repro_torch.comms import (CollectiveContext, Stacked,
                                   partition_buckets, tree_reduce_scatter)
    from repro_torch.kernels import CHUNK_ACCUM_KERNEL
    from repro_torch.kernels import chunk_accum_indexed_reference
    shapes = _grad_shapes(TRAIN_ARGV[1])
    meta = {n: torch.empty(sh, device="meta") for n, sh in shapes.items()}
    elems_per_rank = sum(math.prod(sh) for sh in shapes.values())
    plain = Stacked(RANKS, accumulate=chunk_accum_indexed_reference)
    results = {}
    CHUNK_ACCUM_KERNEL.launches = 0
    for label, topo in (("data-ring8", None), ("dgx:8", "dgx:8")):
        ctx = CollectiveContext({"data": RANKS},
                                topologies={"data": topo} if topo else None)
        red = ctx.bucketed_allreduce("data", Stacked(RANKS),
                                     wire_dtype=None)
        buckets = partition_buckets(meta, red.bucket_bytes)
        gens = [torch.Generator(device=DEV).manual_seed(
            seed * 1000 + r) for r in range(RANKS)]
        before = CHUNK_ACCUM_KERNEL.launches
        reduce_s, worst, largest = [], 0.0, 0
        t_all = time.perf_counter()
        for bucket in buckets:
            n = sum(math.prod(shapes[k]) for k in bucket)
            largest = max(largest, n)
            stack = torch.empty((RANKS, n), device=DEV)
            for r in range(RANKS):
                stack[r].normal_(generator=gens[r])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = red.reduce_bucket(stack)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)
            for r in range(1, RANKS):
                assert torch.equal(out[r], out[0]), (label, bucket, r)
            # the reduce-scatter of the same layout (pad, then [A, n / A])
            # with the plain accumulate: rank i's shard is the i-th piece
            pad = (-n) % RANKS
            split = torch.nn.functional.pad(stack, (0, pad)) if pad \
                else stack
            shards = tree_reduce_scatter(split.view(RANKS, RANKS, -1),
                                         red.rs_prog, plain,
                                         accum_dtype=torch.float32)
            del split
            assert torch.equal(out[0], shards.reshape(-1)[:n]), \
                (label, bucket)
            del shards
            worst = max(worst, (out[0] - stack.sum(0)).abs().max().item())
            del stack, out
        launches = CHUNK_ACCUM_KERNEL.launches - before
        assert launches > 0, label
        assert worst <= STACK_ATOL, (label, worst)
        rs = red.rs_prog
        res = dict(topology=label, graph=ctx.topology("data").name,
                   ranks=RANKS, elems_per_rank=elems_per_rank,
                   gb_per_rank=elems_per_rank * 4 / 1e9,
                   buckets=len(buckets), largest_bucket_elems=largest,
                   rs_calls=rs.num_calls, slots_per_shard=rs.slots_per_shard,
                   chunk_accum_launches=launches,
                   reduce_s_total=sum(reduce_s),
                   reduce_s_per_bucket=sum(reduce_s) / len(reduce_s),
                   reduce_s_largest_bucket=max(reduce_s),
                   phase_s=time.perf_counter() - t_all,
                   max_abs_err_vs_sum=worst, atol=STACK_ATOL,
                   bit_equal_plain_accumulate=True, ranks_equal=True)
        emit("collectives_stacked", **res)
        results[label] = res
        torch.cuda.empty_cache()
    results["launches"] = CHUNK_ACCUM_KERNEL.launches
    return results


def phase_train(seed: int) -> dict:
    from repro_torch.kernels import CHUNK_ACCUM_KERNEL, FLASH_KERNEL
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = TRAIN_ARGV + ["--device", DEV, "--seed", str(seed), "--ckpt-dir",
                         ckpt]
    flash, accum = FLASH_KERNEL.launches, CHUNK_ACCUM_KERNEL.launches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        records = launch_train.run(
            launch_train.build_parser().parse_args(argv))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in records]
    assert all(math.isfinite(l) for l in losses), losses
    # under autograd attention takes the plain path; one rank, no collective
    assert FLASH_KERNEL.launches == flash
    assert CHUNK_ACCUM_KERNEL.launches == accum
    steady = records[1:]
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARGV[1])
    res = dict(command="repro_torch.launch.train " + " ".join(argv),
               layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, reduced="--reduced" in argv,
               compute_dtype="float32" if "--reduced" in argv
               else "bfloat16", params_dtype="float32",
               losses=losses, step_s=[r["seconds"] for r in records],
               tokens_per_step=records[0]["tokens"],
               steady_tok_per_s=sum(r["tokens"] for r in steady)
               / sum(r["seconds"] for r in steady),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, wall_s=wall,
               final_checkpoint=dict(checkpoint.timings))
    emit("train", **res)
    torch.cuda.empty_cache()
    return res


def phase_train_vs_cpu(seed: int) -> None:
    for name in ("qwen3-8b", "gemma2-2b"):
        _, losses, _, cpu, gpu = _train_pair(name, seed, seq=64, batch=4,
                                             steps=2)
        assert all(math.isfinite(lg) for _, lg in losses)
        loss_err, param_err = _train_errs(losses, cpu, gpu)
        assert loss_err <= TRAIN_LOSS_RTOL, (name, loss_err)
        assert param_err <= TRAIN_PARAM_ATOL, (name, param_err)
        emit("train_vs_cpu", arch=name, reduced=True, steps=2,
             max_rel_loss_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
             max_abs_param_err=param_err, param_atol=TRAIN_PARAM_ATOL)


def _train_pair(name: str, seed: int, seq: int, batch: int, steps: int):
    """(config, [(cpu loss, card loss)], blockwise calls per step and side,
    cpu params, card params) of `steps` train steps of reduced `name` from
    one init on the CPU and on the card."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.attention import BLOCKWISE
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   host_batch_slice, init_adamw,
                                   make_train_step)
    cfg = reduced_config(name)
    model = build_model(cfg, remat=True)
    cpu = model.init(seed, torch.float32, "cpu")
    gpu = copy.deepcopy(cpu).to(DEV)
    step = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps)))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch, seed=seed,
                    num_image_tokens=cfg.num_image_tokens,
                    encoder_seq=cfg.encoder_seq if cfg.is_encoder_decoder
                    else 0, d_model=cfg.d_model)
    opt_c, opt_g = init_adamw(cpu), init_adamw(gpu)
    losses, calls = [], []
    for i in range(steps):
        data = host_batch_slice(dc, i, 0, batch)
        before = BLOCKWISE.calls
        cpu, opt_c, mc = step(cpu, opt_c, data)
        calls.append(BLOCKWISE.calls - before)
        before = BLOCKWISE.calls
        gpu, opt_g, mg = step(gpu, opt_g,
                              {k: v.to(DEV) for k, v in data.items()})
        calls.append(BLOCKWISE.calls - before)
        losses.append((float(mc["loss"]), float(mg["loss"])))
    return cfg, losses, calls, cpu, gpu


def _train_errs(losses, cpu, gpu):
    """(largest relative loss gap, largest absolute param gap), card vs
    CPU."""
    return (max(abs(lg - lc) / abs(lc) for lc, lg in losses),
            max((pg.cpu() - pc).abs().max().item() for pc, pg in
                zip(cpu.parameters(), gpu.parameters())))


def phase_train_entry_point() -> None:
    t0 = time.perf_counter()
    cmd = ["-m", "repro_torch.launch.train", "--arch", "qwen3-8b",
           "--reduced", "--steps", "2", "--collectives", "pipeline"]
    with tempfile.TemporaryDirectory() as ckpt:
        proc = subprocess.run(
            [sys.executable, *cmd, "--ckpt-dir", ckpt], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    # the supervisor's counts follow the step on the launcher's last line
    assert re.fullmatch(r"done at step 2; stragglers: \d+; link faults "
                        r"repaired: False", lines[-1]), proc.stdout
    assert "data-parallel 1: no collective runs" in lines, proc.stdout
    emit("train_entry_point", command="python " + " ".join(cmd),
         rc=proc.returncode, seconds=time.perf_counter() - t0)


def _p2p_rank(rank: int, world: int, port: int, seed: int, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.api import Collectives
    from repro_torch.comms import P2P, tree_all_reduce
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        rs, ag = Collectives().program(f"bring:{world}", kind="allreduce")
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + rank)
        x = torch.randn(1 << 22, generator=gen, device="cuda")
        y = tree_all_reduce(x, rs, ag, P2P())
        torch.save(y.cpu(), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_nccl_p2p(seed: int) -> None:
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("nccl_p2p", run=False, cards=cards)
        return
    import socket

    import torch.multiprocessing as mp

    from repro_torch.api import Collectives
    from repro_torch.comms import Stacked, tree_all_reduce
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        mp.spawn(_p2p_rank, args=(cards, port, seed, out), nprocs=cards,
                 join=True)
        got = [torch.load(os.path.join(out, f"rank{r}.pt"))
               for r in range(cards)]
    rs, ag = Collectives().program(f"bring:{cards}", kind="allreduce")
    stack = torch.stack([
        torch.randn(1 << 22, generator=torch.Generator(device="cuda")
                    .manual_seed(seed * 1000 + r), device="cuda")
        for r in range(cards)])
    ref = tree_all_reduce(stack, rs, ag, Stacked(cards)).cpu()
    for r in range(cards):
        assert torch.equal(got[r], ref[r]), r
    emit("nccl_p2p", run=True, cards=cards, elems=1 << 22,
         bit_equal_stacked=True, seconds=time.perf_counter() - t0)


def _ssd_inputs(gen, b, s, h, p, n, dtype):
    """x [B,S,H,P], dt [B,S,H] f32 (softplus of a normal), a [H] (-exp of a
    normal), b, c [B,S,N] shared by every head: the distributions of
    tests/test_kernels.py, in the model's layout."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    return (rnd(b, s, h, p).to(dtype),
            torch.nn.functional.softplus(rnd(b, s, h)), -torch.exp(rnd(h)),
            rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype))


def _ssd_err(got, ref, dtype):
    """(max abs error, within tolerance, bit-equal) of (y, states) against
    the plain version's."""
    (gy, gs), (ry, rs) = got, ref
    ytol = SSD_TOL if dtype == torch.float32 else SSD_TOL_BF16_Y
    ok = torch.allclose(gy.float(), ry.float(), **ytol) and \
        torch.allclose(gs, rs, **SSD_TOL)
    err = max((gy.float() - ry.float()).abs().max().item(),
              (gs - rs).abs().max().item())
    return err, ok, torch.equal(gy, ry) and torch.equal(gs, rs)


def _heads(x, dt, a, b, c) -> tuple:
    """The model's x [B,S,H,P], dt [B,S,H], a [H], b, c [B,S,N] as the
    heads-layout views the SSD kernels read, as `ops.ssd_chunked_bshp`
    forms them."""
    return (x.transpose(1, 2), dt.transpose(1, 2),
            a.expand(x.shape[0], x.shape[2]), b[:, None], c[:, None])


def _ssd_block(x, dt, a, b, c, q) -> tuple:
    """Steps 1 and 2 on the SSD kernel in the model's layout: (y
    [B,S,H,P], states [B,L,H,P,N]) written through transposed views, as
    the chunked SSD's Function writes them."""
    from repro_torch.kernels import ssd_chunk_intra_heads
    bs, s, h, p = x.shape
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    st = torch.empty((bs, s // q, h, p, b.shape[-1]), device=x.device)
    ssd_chunk_intra_heads(*_heads(x, dt, a, b, c), q, y=y.transpose(1, 2),
                          states=st.transpose(1, 2))
    return y, st


def _ssd_block_bwd(x, dt, a, b, c, dy, dst, q) -> None:
    """The SSD block's backward in the model's layout (dy [B,S,H,P], dst
    [B,L,H,P,N]), its gradients written through transposed views of
    [B,S,...] tensors, as the chunked SSD Function's backward writes
    them."""
    from repro_torch.kernels import ssd_chunk_intra_bwd_heads
    bs, s, h, p = x.shape
    dx = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((bs, s, h), device=x.device)
    db, dc = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
              for t in (b, c))
    ssd_chunk_intra_bwd_heads(
        *_heads(x, dt, a, b, c), dy.transpose(1, 2), dst.transpose(1, 2), q,
        dx=dx.transpose(1, 2), ddt=ddt.transpose(1, 2), db=db[:, None],
        dc=dc[:, None])


def phase_ssd_vs_plain(seed: int) -> dict:
    from repro_torch.kernels import ssd_chunk_intra
    gen = torch.Generator(device=DEV).manual_seed(seed)
    pns = [(16, 16), (32, 64), (64, 128), (128, 32), (64, 64), (128, 128)]
    dtypes = (torch.float32, torch.bfloat16)
    worst = {dtype: 0.0 for dtype in dtypes}
    cases = {str(dtype)[6:]: 0 for dtype in dtypes}     # "float32": ...
    equal = dict(cases)
    failures, fp32_unequal = [], []

    def check(label, got, ref, dtype, q, p, n, inputs):
        err, ok, same = _ssd_err(got, ref, dtype)
        cases[str(dtype)[6:]] += 1
        equal[str(dtype)[6:]] += same
        worst[dtype] = max(worst[dtype], err)
        if not ok:
            failures.append((label, str(dtype), q, p, n, err))
        if dtype == torch.float32 and not same:
            fp32_unequal.append(_ssd_unequal(label, got, ref, q, p, n,
                                             inputs))

    # chunks of whole tiles (64 rows) and ragged ones (48, 100, 129), every
    # (P, N); the entry point's extremes (1 row, 4096 rows) and a long
    # ragged chunk at the serving widths
    shapes = [(q, p, n) for q in (16, 48, 64, 100, 129, 256, 512)
              for p, n in pns]
    shapes += [(1, 16, 16), (1000, 64, 128), (4096, 64, 128), (4096, 128, 32)]
    for dtype in dtypes:
        for q, p, n in shapes:
            x, dt, a, b, c = _ssd_inputs(gen, 2, 2 * q, 3, p, n, dtype)
            ref = _ssd_plain(x, dt, a, b, c, q)
            # the model's layout: transposed views, shared b and c
            got = _ssd_block(x, dt, a, b, c, q)
            torch.cuda.synchronize()
            check("bshp", got, ref, dtype, q, p, n, (x, dt, a, b, c))
            # the Pallas layout, on flat copies
            bs, s, h = x.shape[:3]
            y, st = ssd_chunk_intra(
                x.transpose(1, 2).reshape(bs * h, s, p),
                dt.transpose(1, 2).reshape(bs * h, s), a.repeat(bs),
                b.repeat_interleave(h, 0), c.repeat_interleave(h, 0), q)
            torch.cuda.synchronize()
            check("flat", (y.view(bs, h, s, p).transpose(1, 2),
                           st.view(bs, h, s // q, p, n).transpose(1, 2)),
                  ref, dtype, q, p, n, (x, dt, a, b, c))
    # b and c as slices of one [B, S, 1 + 2N] tensor, rows 2 bytes off 16:
    # the wrapper copies them to dense ones for the bf16 loads
    for q, p, n in ((64, 64, 128), (129, 32, 64)):
        x, dt, a, b, c = _ssd_inputs(gen, 2, 2 * q, 3, p, n, torch.bfloat16)
        bc = torch.cat([b[..., :1], b, c], dim=-1)
        b, c = bc[..., 1:1 + n], bc[..., 1 + n:]
        ref = _ssd_plain(x, dt, a, b, c, q)
        got = _ssd_block(x, dt, a, b, c, q)
        torch.cuda.synchronize()
        check("unaligned_bc", got, ref, torch.bfloat16, q, p, n, None)
    assert not failures, f"SSD kernel disagrees with its plain version: " \
        f"{failures}"
    # fp32 is bit-equal to the plain version but for the documented
    # exception: a chunk of one row, where y must then equal the kernel's
    # own order of adds
    unexplained = [c for c in fp32_unequal
                   if not (c["q"] == 1 and c["y_in_kernel_order"])]
    assert not unexplained, f"fp32 SSD not bit-equal: {unexplained}"

    res = dict(cases=sum(cases.values()), cases_per_dtype=cases,
               bit_equal_cases=equal, fp32_not_bit_equal=fp32_unequal,
               max_abs_err_f32=worst[torch.float32],
               max_abs_err_bf16=worst[torch.bfloat16],
               tol_f32=SSD_TOL, tol_bf16_y=SSD_TOL_BF16_Y)
    # the serving shapes: mamba2-780m's (the table's row) and zamba2-1.2b's
    main = _ssd_time(gen, SSD_MAIN)
    res.update(main, library_ms=None,
               library="none: no single PyTorch call computes this function",
               zamba2=_ssd_time(gen, SSD_ZAMBA2),
               local_heads=_ssd_local_heads(gen))
    # the backward: the five gradients against plain autograd at the
    # forward's edge shapes, then at the train shapes with times
    res.update(backward=_ssd_bwd_cases(gen, shapes, pns),
               backward_train=_ssd_bwd_time(gen, SSD_TRAIN),
               backward_zamba2=_ssd_bwd_time(gen, SSD_TRAIN_ZAMBA2))
    # steps 3 and 4: the state kernels' times at the train shapes, and the
    # Function of all four steps on every head count, with an initial state
    res.update(state_train=_ssd_state_time(gen, SSD_TRAIN),
               state_zamba2=_ssd_state_time(gen, SSD_TRAIN_ZAMBA2),
               chunked=_ssd_chunked_cases(gen))
    emit("ssd_vs_plain", **res)
    torch.cuda.empty_cache()
    return res


def _ssd_unequal(label, got, ref, q, p, n, inputs) -> dict:
    """Where an fp32 case differs from the plain version: per output, the
    differing elements, the first one's index and the largest gap.  For a
    chunk of one row, y = (C . B) x dt with L = 1: whether the kernel's y
    equals C . B summed over n in order, one fused multiply-add at a time
    (each emulated as a float64 product and sum rounded to float32), times
    x dt, which is the kernel's order."""
    out = dict(label=label, q=q, p=p, n=n)
    for name, g, r in (("y", got[0], ref[0]), ("states", got[1], ref[1])):
        if not torch.equal(g, r):
            d = g != r
            out[name] = dict(differing=int(d.sum()), of=d.numel(),
                             first_index=d.nonzero()[0].tolist(),
                             max_abs_gap=(g - r).abs().max().item())
    if q == 1:
        x, dt, _, b, c = inputs
        s = torch.zeros(b.shape[:2], dtype=torch.float32, device=b.device)
        for k in range(n):
            s = (c[..., k].double() * b[..., k].double() + s.double()).float()
        y = s[:, :, None, None] * (x * dt[..., None])
        out["y_in_kernel_order"] = torch.equal(got[0], y)
    return out


def _ssd_time(gen, m: dict, sets: int = 4) -> dict:
    """Error against the plain version, times, and bound of the SSD block at
    one serving shape, bf16, as the model calls it, rotating over `sets`
    inputs (tens of MB moved per call, beyond L2 in all).  kernel_ms is
    device time per call from a CUDA graph of the `sets` calls (the
    wrapper's host cost drops out); kernel_eager_ms has it."""
    inputs = [_ssd_inputs(gen, m["b"], m["s"], m["h"], m["p"], m["n"],
                          torch.bfloat16) for _ in range(sets)]
    err, ok, _ = _ssd_err(
        _ssd_block(*inputs[0], m["q"]),
        _ssd_plain(*inputs[0], m["q"]), torch.bfloat16)
    assert ok, (m, err)

    def kernel():
        for args in inputs:
            _ssd_block(*args, m["q"])

    def plain():
        for args in inputs:
            _ssd_plain(*args, m["q"])

    plain_ms = cuda_ms(plain, iters=3, warmup=1) / sets
    kernel_ms = graph_ms(kernel, sets)
    eager_ms = cuda_ms(kernel, iters=10) / sets
    kernel_ms = (kernel_ms + graph_ms(kernel, sets)) / 2
    plain_ms = (plain_ms + cuda_ms(plain, iters=3, warmup=1) / sets) / 2
    flops, nbytes, bound = _ssd_bound(m)
    bound_by = max(bound, key=bound.get)
    return dict(main_shape=m, main_dtype="bfloat16", main_max_abs_err=err,
                kernel_ms=kernel_ms, kernel_eager_ms=eager_ms,
                plain_ms=plain_ms,
                timing=f"kernel_ms: device time per call, CUDA graph of "
                       f"{sets} calls on {sets} input sets; kernel_eager_ms, "
                       f"plain_ms: eager calls",
                bound_ms=bound[bound_by], bound_by=bound_by, flops=flops,
                bytes=nbytes, tflops=flops / kernel_ms / 1e9,
                bound_fraction=bound[bound_by] / kernel_ms,
                fp32_core_bound_ms=flops / PEAK_F32_FLOPS * 1e3,
                timed_sets=sets)


def _ssd_bound(m: dict) -> tuple:
    """(FLOPs, bytes, {"operations": ms, "bytes": ms}) of one bf16 SSD block
    call at shape m: C.B^T over the causal pairs i >= j once per batch row
    (b and c are shared by every head, one group), and per head its
    masked product with x and the state; x and y (bf16), dt, a (f32), b,
    c (bf16) and the f32 states each moved once."""
    bh, chunks, q = m["b"] * m["h"], m["s"] // m["q"], m["q"]
    pairs = q * (q + 1) // 2
    flops = 2 * chunks * (m["b"] * pairs * m["n"]
                          + bh * (pairs * m["p"] + q * m["p"] * m["n"]))
    nbytes = (2 * 2 * bh * m["s"] * m["p"] + 4 * bh * m["s"] + 4 * m["h"]
              + 2 * 2 * m["b"] * m["s"] * m["n"]
              + 4 * bh * chunks * m["p"] * m["n"])
    return flops, nbytes, {"operations": flops / PEAK_BF16_FLOPS * 1e3,
                           "bytes": nbytes / PEAK_BYTES * 1e3}


GRAD_NAMES = ("dx", "ddt", "da", "db", "dc")


def _ssd_plain(x, dt, a, b, c, q) -> tuple:
    """The SSD block's plain version (`ref.ssd_chunk_intra_heads_reference`)
    in the model's layout, under autograd through its own ops: the
    kernels' yardstick."""
    from repro_torch.kernels.ref import ssd_chunk_intra_heads_reference
    y, st = ssd_chunk_intra_heads_reference(*_heads(x, dt, a, b, c), q)
    return y.transpose(1, 2), st.transpose(1, 2)


def _st_round(t, dtype):
    """t's value rounded to dtype, its gradient passed through unrounded."""
    return t + (t.to(dtype).to(t.dtype) - t).detach()


def _ssd_chunked_plain(x, dt, a, b, c, q, init=None) -> tuple:
    """All four steps of the chunked SSD, plain (`_ssd_plain` for steps 1
    and 2; steps 3 and 4 as `models/ssm.py` ran them before the state
    kernels), in float32 with the values rounded to x's dtype where the
    kernels round them (the entering states, the state decay, the
    read-out, y) and the gradients passed through those roundings in
    float32: the function the kernels compute, under autograd without
    bf16 gradients.  Autograd of the model's own bf16 ops rounds d(state
    decay) and d(entering) to bf16, and scatters ddt by ~5e-4 of its size
    on its own (a CPU run of both at 1 x 1024 x 4 heads).  c is cast to
    float32 once for all four steps, so its gradient is rounded once, as
    the kernels round dc."""
    cdt = x.dtype
    c = c.float()
    y_diag, states = _ssd_plain(x, dt, a, b, c, q)
    bs, s, h, p = x.shape
    n, l = b.shape[-1], s // q
    da_cs = torch.cumsum((dt * a).reshape(bs, l, q, h), dim=2)
    decay = torch.exp(da_cs[:, :, -1, :])
    carry = init.float() if init is not None else \
        torch.zeros((bs, h, p, n), device=x.device)
    entering = []
    for i in range(l):
        entering.append(_st_round(carry, cdt))
        carry = carry * decay[:, i, :, None, None] + states[:, i]
    entering = torch.stack(entering, dim=1)
    sd = _st_round(torch.exp(da_cs), cdt)
    y_off = _st_round(torch.einsum("blqn,blhpn->blqhp",
                                   c.reshape(bs, l, q, n), entering)
                      * sd[..., None], cdt)
    return _st_round(y_diag.float() + y_off.reshape(bs, s, h, p), cdt), carry


def _ssd_grads(x, dt, a, b, c, q, dy, dfin, plain: bool,
               init=None) -> tuple:
    """(the gradients of x, dt, a, b, c (and init), the outputs [y, final
    state]) given dy and the final state's gradient: through the chunked
    SSD's autograd Function, or (plain) autograd of `_ssd_chunked_plain`.
    The leaves keep the inputs' strides (a head slice stays one)."""
    from repro_torch.kernels import ssd_chunked_bshp
    ins = [t.detach().requires_grad_() for t in (x, dt, a, b, c)]
    il = None if init is None else init.detach().requires_grad_()
    y, fin = (_ssd_chunked_plain if plain else ssd_chunked_bshp)(*ins, q, il)
    torch.autograd.backward((y, fin), (dy, dfin))
    return ([t.grad for t in ins] + ([il.grad] if il is not None else []),
            [y.detach(), fin.detach()])


def _rel_err(g, r) -> float:
    """g's largest error over r's largest magnitude."""
    return ((g.float() - r.float()).abs().max()
            / r.float().abs().max().clamp_min(1e-30)).item()


def _grad_errs(got, ref) -> dict:
    """Each gradient's largest error over its largest magnitude (dinit,
    the initial state's, where there is one)."""
    return {name: _rel_err(g, r)
            for name, g, r in zip(GRAD_NAMES + ("dinit",), got, ref)}


def _out_errs(got, ref, dtype) -> tuple:
    """({"y", "final"}: each output's largest error over its largest
    magnitude, whether both are within bounds): y within one rounding of
    its dtype (dx's tolerance: 2**-7 for bf16), the float32 final state
    within 1e-5."""
    errs = dict(y=_rel_err(got[0], ref[0]), final=_rel_err(got[1], ref[1]))
    return errs, (errs["y"] <= SSD_BWD_TOL[dtype]["dx"]
                  and errs["final"] <= 1e-5)


def _ssd_bwd_inputs(gen, b, s, h, p, n, q, dtype):
    """The inputs, dy and the final state's gradient dfin [B,H,P,N]."""
    x, dt, a, bb, cc = _ssd_inputs(gen, b, s, h, p, n, dtype)
    dy = torch.randn(b, s, h, p, generator=gen, device=DEV).to(dtype)
    dfin = torch.randn(b, h, p, n, generator=gen, device=DEV)
    return (x, dt, a, bb, cc), dy, dfin


def _ssd_bwd_cases(gen, shapes, pns) -> dict:
    """The backward kernels (the chunked SSD's autograd Function: the state
    passes' and the block's) against plain autograd of all four steps
    (`_ssd_chunked_plain`) in both dtypes at the forward sweep's chunks
    (whole, ragged, one row) and every (P, N), on the model's layout (b, c
    shared, G = 1); the block's backward with G = H through the heads
    layout against its plain backward; a chunk whose decay overflows
    float32's exp; and each case run twice, bit-equal."""
    from repro_torch.kernels import ssd_chunk_intra_bwd_heads
    from repro_torch.kernels.ref import ssd_chunk_intra_bwd_reference
    worst, failures, unequal, cases = {}, [], [], 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = SSD_BWD_TOL[dtype]
        worst[str(dtype)[6:]] = dict.fromkeys(GRAD_NAMES, 0.0)
        for q, p, n in shapes:
            ins, dy, dfin = _ssd_bwd_inputs(gen, 2, 2 * q, 3, p, n, q,
                                            dtype)
            if (q, p, n) == (64, 64, 64):     # cum over -300: exp overflows
                ins = (ins[0], ins[1] + 1.0, ins[2] * 20.0) + ins[3:]
            got, _ = _ssd_grads(*ins, q, dy, dfin, plain=False)
            again, _ = _ssd_grads(*ins, q, dy, dfin, plain=False)
            ref, _ = _ssd_grads(*ins, q, dy, dfin, plain=True)
            torch.cuda.synchronize()
            errs = _grad_errs(got, ref)
            cases += 1
            for k, v in errs.items():
                worst[str(dtype)[6:]][k] = max(worst[str(dtype)[6:]][k], v)
            if not all(torch.isfinite(g).all() for g in got) or \
                    any(errs[k] > tol[k] for k in GRAD_NAMES):
                failures.append((str(dtype), q, p, n, errs))
            if not all(torch.equal(g, h) for g, h in zip(got, again)):
                unequal.append((str(dtype), q, p, n))
        # G = H: each head its own b, c, through the heads layout
        for q, p, n in ((64, 32, 64), (129, 64, 128), (512, 64, 128)):
            (x, dt, a, bb, cc), dy, _ = _ssd_bwd_inputs(
                gen, 2, 2 * q, 3, p, n, q, dtype)
            dst = torch.randn(2, 2, 3, p, n, generator=gen, device=DEV)
            bh = torch.randn(2, 3, 2 * q, n, generator=gen,
                             device=DEV).to(dtype)
            ch = torch.randn(2, 3, 2 * q, n, generator=gen,
                             device=DEV).to(dtype)
            views = (x.transpose(1, 2), dt.transpose(1, 2), a.expand(2, 3),
                     bh, ch, dy.transpose(1, 2), dst.transpose(1, 2))
            got = ssd_chunk_intra_bwd_heads(*views, q)
            ref = ssd_chunk_intra_bwd_reference(*views, q)
            torch.cuda.synchronize()
            errs = _grad_errs(got, ref)
            cases += 1
            if not all(torch.isfinite(g).all() for g in got) or \
                    any(errs[k] > tol[k] for k in GRAD_NAMES):
                failures.append((str(dtype), "G=H", q, p, n, errs))
    assert not failures, f"SSD backward disagrees with plain autograd: " \
        f"{failures}"
    assert not unequal, f"SSD backward not bit-equal run to run: {unequal}"
    return dict(cases=cases, worst=worst,
                tol={str(k)[6:]: v for k, v in SSD_BWD_TOL.items()},
                bit_equal_run_to_run=True)


def _ssd_bwd_bound(m: dict) -> tuple:
    """(FLOPs, bytes, {"operations": ms, "bytes": ms}) of one bf16 SSD
    backward at shape m: over the causal pairs i >= j, C.B^T, dC and dB
    once per batch row (one group) and per head dM and M^T dy, and the
    states' two terms per head; x, dy, dx (bf16), dt, ddt (f32), b, c, db,
    dc (bf16) and dstates (f32) each moved once."""
    bh, chunks, q = m["b"] * m["h"], m["s"] // m["q"], m["q"]
    pairs = q * (q + 1) // 2
    flops = 2 * chunks * (3 * m["b"] * pairs * m["n"]
                          + bh * (2 * pairs * m["p"]
                                  + 2 * q * m["p"] * m["n"]))
    nbytes = (3 * 2 * bh * m["s"] * m["p"] + 2 * 4 * bh * m["s"]
              + 2 * 4 * m["h"] + 4 * 2 * m["b"] * m["s"] * m["n"]
              + 4 * bh * chunks * m["p"] * m["n"])
    return flops, nbytes, {"operations": flops / PEAK_BF16_FLOPS * 1e3,
                           "bytes": nbytes / PEAK_BYTES * 1e3}


def _ssd_bwd_time(gen, m: dict, sets: int = 2) -> dict:
    """The bf16 SSD block's backward at a train shape, as the model's
    autograd Function calls it: the Function's outputs (y, the final
    state; `_out_errs`) and gradients (all four steps) against plain
    autograd of `_ssd_chunked_plain`, bit-equal run to run; the block's
    backward
    alone, device time per call from a CUDA graph over `sets` input sets
    (eager in kernel_eager_ms) beside the bound, the plain autograd
    backward's time and the forward kernel's."""
    from repro_torch.kernels import SSD_BWD_KERNEL
    sets_in = [_ssd_bwd_inputs(gen, m["b"], m["s"], m["h"], m["p"], m["n"],
                               m["q"], torch.bfloat16) for _ in range(sets)]
    ins, dy, dfin = sets_in[0]
    got, outs = _ssd_grads(*ins, m["q"], dy, dfin, plain=False)
    again, outs_again = _ssd_grads(*ins, m["q"], dy, dfin, plain=False)
    ref, outs_ref = _ssd_grads(*ins, m["q"], dy, dfin, plain=True)
    errs = _grad_errs(got, ref)
    out_errs, out_ok = _out_errs(outs, outs_ref, torch.bfloat16)
    tol = SSD_BWD_TOL[torch.bfloat16]
    assert all(errs[k] <= tol[k] for k in GRAD_NAMES), (m, errs)
    assert out_ok, (m, out_errs)
    same = all(torch.equal(g, h) for g, h in zip(got + outs,
                                                 again + outs_again))
    assert same, m
    del got, again, ref, outs, outs_again, outs_ref

    # the block's backward alone, as the autograd Function runs it
    dsts = [torch.randn(m["b"], m["s"] // m["q"], m["h"], m["p"], m["n"],
                        generator=gen, device=DEV) for _ in range(sets)]

    def kernel():
        for (ins, dy, _), dst in zip(sets_in, dsts):
            _ssd_block_bwd(*ins, dy, dst, m["q"])

    before = SSD_BWD_KERNEL.launches
    kernel_ms = graph_ms(kernel, sets)
    eager_ms = cuda_ms(kernel, iters=5) / sets
    kernel_ms = (kernel_ms + graph_ms(kernel, sets)) / 2
    launches = SSD_BWD_KERNEL.launches - before

    def forward():
        for ins, _, _ in sets_in:
            _ssd_block(*ins, m["q"])
    fwd_ms = graph_ms(forward, sets)
    # plain autograd: the graph of the plain version, its backward timed
    ins, dy, _ = sets_in[0]
    leaves = [t.detach().requires_grad_() for t in ins]
    outs = _ssd_plain(*leaves, m["q"])
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        outs, leaves, (dy, dsts[0]), retain_graph=True), iters=3, warmup=1)
    del outs, leaves
    flops, nbytes, bound = _ssd_bwd_bound(m)
    bound_by = max(bound, key=bound.get)
    torch.cuda.empty_cache()
    return dict(shape=m, dtype="bfloat16", grad_errs=errs,
                out_errs=out_errs, bit_equal_run_to_run=same,
                kernel_ms=kernel_ms,
                kernel_eager_ms=eager_ms, plain_autograd_ms=plain_ms,
                forward_kernel_ms=fwd_ms, launches_timed=launches,
                timing=f"kernel_ms: device time per backward call (the "
                       f"autograd Function's), CUDA graph of {sets} calls on "
                       f"{sets} input sets; eager and plain autograd: eager "
                       f"calls",
                bound_ms=bound[bound_by], bound_by=bound_by, flops=flops,
                bytes=nbytes, tflops=flops / kernel_ms / 1e9,
                bound_fraction=bound[bound_by] / kernel_ms)


def _ssd_state_bound(m: dict) -> dict:
    """Bytes, FLOPs and the least ms of the state kernels at shape m, bf16.
    Forward: the float32 states read, y_diag read and y written, the
    float32 carries and the bf16 entering states written, c and dt read,
    cs written; the read-out's products 2 B S H P N.  Backward: dy, the
    carries, the entering states, c and cs read, the float32 dstates, dcs
    and dc written; dE's and dy E's products, 4 B S H P N."""
    bh, s, p, n = m["b"] * m["h"], m["s"], m["p"], m["n"]
    st = 4 * bh * (s // m["q"]) * p * n
    fwd = st + 2 * 2 * bh * s * p + st + st // 2 + 2 * m["b"] * s * n \
        + 2 * 4 * bh * s
    bwd = 2 * bh * s * p + st + st // 2 + 2 * m["b"] * s * n + 4 * bh * s \
        + st + 4 * bh * s + 4 * m["b"] * s * n
    out = {}
    for name, nbytes, flops in (("forward", fwd, 2 * bh * s * p * n),
                                ("backward", bwd, 4 * bh * s * p * n)):
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": flops / PEAK_BF16_FLOPS * 1e3}
        by = max(bound, key=bound.get)
        out[name] = dict(bytes=nbytes, flops=flops, bound_ms=bound[by],
                         bound_by=by)
    return out


def _ssd_state_time(gen, m: dict, sets: int = 2) -> dict:
    """Steps 3 and 4's kernels at a train shape, bf16, as the autograd
    Function calls them: device time per call of the forward (the state
    pass and the read-out) and of the backward (the products and the
    walk) from a CUDA graph over `sets` input sets (each beyond L2; eager
    in *_eager_ms), beside their bytes bounds, the plain steps' forward and
    their backward under plain autograd, and the launches counted."""
    from repro_torch.kernels import SSD_STATE_BWD_KERNEL, SSD_STATE_KERNEL
    from repro_torch.kernels.ref import ssd_state_reference
    from repro_torch.kernels.ssd_state import (ssd_state_bwd_heads,
                                               ssd_state_heads)
    bs, s, h, p, n, q = (m[k] for k in "bshpnq")
    sets_in = []
    for _ in range(sets):
        x, dt, a, _, c = _ssd_inputs(gen, bs, s, h, p, n, torch.bfloat16)
        y = torch.randn(bs, s, h, p, generator=gen,
                        device=DEV).to(torch.bfloat16)
        st = torch.randn(bs, s // q, h, p, n, generator=gen, device=DEV)
        dy = torch.randn(bs, s, h, p, generator=gen,
                         device=DEV).to(torch.bfloat16)
        sets_in.append((y, st, dt, a, c, dy))

    def views(y, st, dt, a, c):
        return (y.transpose(1, 2), st.transpose(1, 2), dt.transpose(1, 2),
                a.expand(bs, h), c[:, None])

    def forward():
        for y, st, dt, a, c, _ in sets_in:
            ssd_state_heads(*views(y, st, dt, a, c), q)
    saved = [ssd_state_heads(*views(*t[:5]), q)[1:] + (t[5], t[4])
             for t in sets_in]

    def backward():
        for ent, car, cs, dy, c in saved:
            ssd_state_bwd_heads(dy.transpose(1, 2), None, car, ent, cs,
                                c[:, None], q)
    before = SSD_STATE_KERNEL.launches, SSD_STATE_BWD_KERNEL.launches
    res = {}
    for name, fn in (("forward", forward), ("backward", backward)):
        kernel_ms = graph_ms(fn, sets)
        eager_ms = cuda_ms(fn, iters=5) / sets
        res[name] = dict(kernel_ms=(kernel_ms + graph_ms(fn, sets)) / 2,
                         kernel_eager_ms=eager_ms)
    launches = (SSD_STATE_KERNEL.launches - before[0],
                SSD_STATE_BWD_KERNEL.launches - before[1])
    # the plain steps (`ref.ssd_state_reference`, the ops `models/ssm.py`
    # ran before the state kernels): the forward eager, the backward under
    # autograd
    y, st, dt, a, c, dy = sets_in[0]
    res["forward"]["plain_ms"] = cuda_ms(
        lambda: ssd_state_reference(*views(y, st, dt, a, c), q), iters=5,
        warmup=1)
    leaves = [t.detach().requires_grad_() for t in (y, st, dt, c)]
    outs = ssd_state_reference(*views(*leaves[:3], a, leaves[3]), q)[:2]
    dfin = torch.zeros_like(outs[1])
    res["backward"]["plain_autograd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(outs, leaves, (dy.transpose(1, 2),
                                                   dfin),
                                    retain_graph=True), iters=3, warmup=1)
    del outs, leaves, saved
    for name, b in _ssd_state_bound(m).items():
        res[name].update(b, bound_fraction=b["bound_ms"]
                         / res[name]["kernel_ms"])
    torch.cuda.empty_cache()
    return dict(shape=m, dtype="bfloat16", launches_timed=launches,
                timing=f"kernel_ms: device time per call, CUDA graph of "
                       f"{sets} calls on {sets} input sets; eager and plain: "
                       f"eager calls", **res)


def _ssd_chunked_cases(gen) -> dict:
    """All four steps' autograd Function (the SSD block's kernels and the
    state kernels, forward and backward) at mamba2-780m's prefill shape
    against plain autograd of `_ssd_chunked_plain`: bf16 and float32, on
    all 48 heads and on the last rank's 24, 12 and 3 of them (head-slice
    views, b and c whole), with and without an initial state; y within
    dx's tolerance and the final state within 1e-5 (each error over the
    output's largest magnitude), every gradient within SSD_BWD_TOL (dinit
    within dc's), each case run twice, bit-equal."""
    m = SSD_MAIN
    worst, failures, unequal, cases = {}, [], [], 0
    for dtype in (torch.bfloat16, torch.float32):
        tol = SSD_BWD_TOL[dtype]
        key = str(dtype)[6:]
        worst[key] = dict.fromkeys(GRAD_NAMES + ("dinit", "y", "final"), 0.0)
        full, dy_full, dfin_full = _ssd_bwd_inputs(
            gen, m["b"], m["s"], m["h"], m["p"], m["n"], m["q"], dtype)
        init_full = torch.randn(m["b"], m["h"], m["p"], m["n"],
                                generator=gen, device=DEV)
        for hl in (48,) + SSD_LOCAL_HEADS:
            heads = slice(m["h"] - hl, m["h"])
            x, dt, a, b, c = full
            ins = (x[:, :, heads], dt[:, :, heads], a[heads], b, c)
            dy, dfin = dy_full[:, :, heads], dfin_full[:, heads]
            for init in (None, init_full[:, heads]):
                got, outs = _ssd_grads(*ins, m["q"], dy, dfin, False, init)
                again, outs_again = _ssd_grads(*ins, m["q"], dy, dfin,
                                               False, init)
                ref, outs_ref = _ssd_grads(*ins, m["q"], dy, dfin, True,
                                           init)
                torch.cuda.synchronize()
                errs = _grad_errs(got, ref)
                fwd, fwd_ok = _out_errs(outs, outs_ref, dtype)
                errs.update(fwd)
                cases += 1
                for k, v in errs.items():
                    worst[key][k] = max(worst[key][k], v)
                if not fwd_ok or not all(torch.isfinite(g).all()
                                         for g in got) or \
                        any(errs[k] > tol[k] for k in GRAD_NAMES) or \
                        (init is not None and errs["dinit"] > tol["dc"]):
                    failures.append((key, hl, init is not None, errs))
                if not all(torch.equal(g, h) for g, h in
                           zip(got + outs, again + outs_again)):
                    unequal.append((key, hl, init is not None))
                del got, again, ref, outs, outs_again, outs_ref
        del full, dy_full, dfin_full
        torch.cuda.empty_cache()
    assert not failures, f"chunked SSD Function disagrees with plain " \
        f"autograd: {failures}"
    assert not unequal, f"chunked SSD Function not bit-equal run to run: " \
        f"{unequal}"
    return dict(cases=cases, heads=(48,) + SSD_LOCAL_HEADS,
                with_init=(False, True), worst=worst,
                tol={str(k)[6:]: v for k, v in SSD_BWD_TOL.items()},
                dinit_tol="dc's", bit_equal_run_to_run=True)


# mamba2-780m's 48 heads over a model axis of 2, 4 and 16 (the placed
# mixer runs the SSD block on each rank's own heads)
SSD_LOCAL_HEADS = (24, 12, 3)


def _ssd_local_heads(gen, sets: int = 4) -> list:
    """The SSD block at mamba2-780m's prefill shape on a model rank's own
    heads, bf16: the last rank's heads of a [B,S,48,P] tensor as a view
    (b and c whole), and the mixer's own layout (x, b and c as views of
    one [B,S,hl*P+2N] conv output).  Each against the plain version to
    phase 13's tolerances, whether `dense_if_unaligned` copied x, b or c,
    and device time per call from a CUDA graph over `sets` input sets,
    beside the bound; then the autograd Function's backward on the same
    views (the leaves keep their strides) against plain autograd within
    SSD_BWD_TOL, bit-equal run to run."""
    from repro_torch.kernels.ssd_scan import dense_if_unaligned
    m = SSD_MAIN
    full = [_ssd_inputs(gen, m["b"], m["s"], m["h"], m["p"], m["n"],
                        torch.bfloat16) for _ in range(sets)]
    out = []
    for hl in SSD_LOCAL_HEADS:
        heads = slice(m["h"] - hl, m["h"])          # the last rank's
        width = hl * m["p"]

        def views(x, dt, a, b, c, layout):
            if layout == "head_slice":
                return x[:, :, heads], dt[:, :, heads], a[heads], b, c
            xbc = torch.cat([x[:, :, heads].reshape(m["b"], m["s"], width),
                             b, c], dim=-1)
            return (xbc[..., :width].view(m["b"], m["s"], hl, m["p"]),
                    dt[:, :, heads], a[heads], xbc[..., width:width + m["n"]],
                    xbc[..., width + m["n"]:])
        for layout in ("head_slice", "mixer"):
            inputs = [views(*f, layout) for f in full]
            err, ok, _ = _ssd_err(
                _ssd_block(*inputs[0], m["q"]),
                _ssd_plain(*inputs[0], m["q"]),
                torch.bfloat16)
            assert ok, (hl, layout, err)
            dy = torch.randn(inputs[0][0].shape, generator=gen,
                             device=DEV).to(torch.bfloat16)
            dfin = torch.randn(m["b"], hl, m["p"], m["n"], generator=gen,
                               device=DEV)
            got, _ = _ssd_grads(*inputs[0], m["q"], dy, dfin, plain=False)
            again, _ = _ssd_grads(*inputs[0], m["q"], dy, dfin,
                                  plain=False)
            ref, _ = _ssd_grads(*inputs[0], m["q"], dy, dfin, plain=True)
            bwd_errs = _grad_errs(got, ref)
            tol = SSD_BWD_TOL[torch.bfloat16]
            assert all(torch.isfinite(g).all() for g in got) and all(
                bwd_errs[k] <= tol[k] for k in GRAD_NAMES), \
                (hl, layout, bwd_errs)
            bwd_same = all(torch.equal(g, h) for g, h in zip(got, again))
            assert bwd_same, (hl, layout)
            del got, again, ref, dy, dfin
            x, _, _, b, c = inputs[0]
            kv = (x.transpose(1, 2), b[:, None], c[:, None])
            copied = [n for n, t, d in zip("xbc", kv, dense_if_unaligned(*kv))
                      if d is not t]

            def kernel():
                for args in inputs:
                    _ssd_block(*args, m["q"])
            kernel_ms = graph_ms(kernel, sets)
            local = dict(m, h=hl)
            flops, nbytes, bound = _ssd_bound(local)
            bound_by = max(bound, key=bound.get)
            out.append(dict(heads=hl, of=m["h"], layout=layout,
                            shape=local, max_abs_err=err, copied=copied,
                            kernel_ms=kernel_ms, bound_ms=bound[bound_by],
                            bound_by=bound_by,
                            bound_fraction=bound[bound_by] / kernel_ms,
                            bwd_grad_errs=bwd_errs,
                            bwd_bit_equal_run_to_run=bwd_same))
            del inputs
    return out


def phase_ssm_model_vs_cpu(seed: int) -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import FLASH_KERNEL, SSD_KERNEL
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import num_shared_sites
    for name in ("mamba2-780m", "zamba2-1.2b"):
        cfg = reduced_config(name)
        model = build_model(cfg)
        cpu = model.init(seed, torch.float32, "cpu")
        gpu = copy.deepcopy(cpu).to(DEV)
        rng = np.random.default_rng(seed)
        b, s, max_len = 2, 2 * cfg.ssm_chunk, 64   # two chunks
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int64))
        ssd, flash = SSD_KERNEL.launches, FLASH_KERNEL.launches
        worst = 0.0
        with torch.inference_mode():
            sc, lc = model.prefill(cpu, {"tokens": tokens},
                                   model.init_decode_state(b, max_len,
                                                           device="cpu"))
            sg, lg = model.prefill(gpu, {"tokens": tokens.to(DEV)},
                                   model.init_decode_state(b, max_len,
                                                           device=DEV))
            ssd, flash = SSD_KERNEL.launches - ssd, \
                FLASH_KERNEL.launches - flash
            for index in range(s, s + 4):
                worst = max(worst, (lg.cpu() - lc).abs().max().item())
                tok = lc[:, -1].argmax(-1)[:, None]
                lc, sc = model.decode_step(cpu, tok, sc, index)
                lg, sg = model.decode_step(gpu, tok.to(DEV), sg, index)
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
        sites = num_shared_sites(cfg) if cfg.family == "hybrid" else 0
        assert torch.isfinite(lg).all()
        assert ssd == cfg.num_layers, (name, ssd)
        assert flash == sites, (name, flash)
        assert worst <= MODEL_ATOL, (name, worst)
        emit("ssm_model_vs_cpu", arch=name, reduced=True, prompt=[b, s],
             decode_steps=4, max_abs_logit_err=worst, atol=MODEL_ATOL,
             ssd_launches_in_prefill=ssd, flash_launches_in_prefill=flash)


SSM_SERVE = {"mamba2-780m": (2048, 1531, 2048, 700),
             "zamba2-1.2b": (1024, 1000, 512, 300)}


def phase_serve_ssm(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_KERNEL, SSD_KERNEL
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import num_shared_sites
    from repro_torch.serve import Request, ServingEngine
    results = {"ssd_launches": 0}
    for name, plens in SSM_SERVE.items():
        cfg = get_config(name)
        model = build_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(seed, torch.bfloat16, DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        new_tokens, batch_size = 16, 2
        engine = ServingEngine(model, params, batch_size=batch_size,
                               max_len=4096)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
                   for n in plens]
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
        batches = [plens[i:i + batch_size]
                   for i in range(0, len(plens), batch_size)]
        assert all(max(bt) % cfg.ssm_chunk == 0 for bt in batches)

        SSD_KERNEL.launches = FLASH_KERNEL.launches = 0
        t0 = time.perf_counter()
        outs = engine.run()
        wall_s = time.perf_counter() - t0
        ssd, flash = SSD_KERNEL.launches, FLASH_KERNEL.launches

        assert [o.uid for o in outs] == list(range(len(plens)))
        for o, p in zip(outs, prompts):
            assert o.prompt_len == len(p)
            assert len(o.tokens) == len(p) + new_tokens
            assert (o.tokens[:len(p)] == p).all()
            new = o.tokens[len(p):]
            assert ((new >= 0) & (new < cfg.vocab_size)).all()
        sites = num_shared_sites(cfg) if cfg.family == "hybrid" else 0
        assert ssd == cfg.num_layers * len(batches), (name, ssd)
        assert flash == sites * len(batches), (name, flash)
        # the first batch's prefill logits: finite, of the expected shape
        with torch.inference_mode():
            toks = torch.from_numpy(np.stack(
                [prompts[0], np.pad(prompts[1], (plens[0] - plens[1], 0))]
            ).astype(np.int64)).to(DEV)
            _, logits = model.prefill(params, {"tokens": toks},
                                      model.init_decode_state(
                                          2, plens[0] + 1, device=DEV))
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        st = engine.stats
        res = dict(arch=name, family=cfg.family, layers=cfg.num_layers,
                   d_model=cfg.d_model, ssm_chunk=cfg.ssm_chunk,
                   dtype="bfloat16", params=n_params, init_s=init_s,
                   prompts=list(plens), batch_size=batch_size,
                   new_tokens=new_tokens, batches=len(batches),
                   wall_s=wall_s, prefill_s=st["prefill_s"],
                   decode_s=st["decode_s"],
                   prefill_tokens=st["prefill_tokens"],
                   decode_tokens=st["decode_tokens"],
                   prefill_tok_per_s=st["prefill_tokens"] / st["prefill_s"],
                   decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
                   ssd_launches=ssd, flash_launches=flash,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9,
                   completions=[[int(t) for t in o.tokens[o.prompt_len:]]
                                for o in outs])
        emit("serve_ssm", **res)
        results[name] = res
        results["ssd_launches"] += ssd
        del engine, params, logits
    torch.cuda.empty_cache()
    return results


def phase_ssm_entry_point() -> None:
    t0 = time.perf_counter()
    cmd = ["-m", "repro_torch.launch.serve", "--arch", "mamba2-780m",
           "--reduced", "--prompt-len", "32"]
    proc = subprocess.run(
        [sys.executable, *cmd], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = [l for l in proc.stdout.splitlines() if l.startswith("req ")]
    assert len(served) == 6, proc.stdout
    emit("ssm_entry_point", command="python " + " ".join(cmd),
         rc=proc.returncode, requests=len(served),
         seconds=time.perf_counter() - t0)


def _fresh_host_state(name: str):
    """An uninitialised (params, AdamWState) of the model at full width on
    the host: the template a checkpoint is restored into."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.train import AdamWState
    with torch.device("meta"):
        lm = DecoderLM(get_config(name))
    lm = lm.to_empty(device="cpu")
    moments = [{n: torch.empty_like(p) for n, p in lm.named_parameters()}
               for _ in range(2)]
    return lm, AdamWState(0, *moments)


def phase_train_long(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import (CHUNK_ACCUM_KERNEL, FLASH_KERNEL,
                                     SSD_KERNEL, adamw)
    from repro_torch.launch import train as launch_train
    from repro_torch.models.attention import BLOCKWISE
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import UPDATED
    cfg = get_config(TRAIN_LONG_ARGV[1])
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_long_")
    argv = TRAIN_LONG_ARGV + ["--device", DEV, "--seed", str(seed),
                              "--ckpt-dir", ckpt]
    args = launch_train.build_parser().parse_args(argv)
    n_params = sum(math.prod(sh) for sh in _grad_shapes(args.arch).values())
    # params, mu and nu in float32, and the optimizer's step
    need = 3 * 4 * n_params
    disk = shutil.disk_usage(ckpt)
    emit("train_long_disk", ckpt_dir=ckpt, free_bytes=disk.free,
         total_bytes=disk.total, checkpoint_bytes_expected=need)
    assert disk.free > 1.1 * need, \
        f"{ckpt} cannot hold one checkpoint ({disk.free} < {need} bytes)"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FLASH_KERNEL.launches = CHUNK_ACCUM_KERNEL.launches = 0
    SSD_KERNEL.launches = BLOCKWISE.calls = 0
    adamw.NORM_KERNEL.launches = adamw.UPDATE_KERNEL.launches = 0
    updated = UPDATED.kernel, UPDATED.loop
    keep = {}
    try:
        t0 = time.perf_counter()
        records = launch_train.run(args, keep=keep)
        wall = time.perf_counter() - t0
        blockwise = BLOCKWISE.calls
        launches = dict(flash_attention=FLASH_KERNEL.launches,
                        chunk_accum=CHUNK_ACCUM_KERNEL.launches,
                        ssd_chunk=SSD_KERNEL.launches,
                        adamw_norm=adamw.NORM_KERNEL.launches,
                        adamw_update=adamw.UPDATE_KERNEL.launches)
        adamw_elements = (UPDATED.kernel - updated[0],
                          UPDATED.loop - updated[1])
        peak = torch.cuda.max_memory_allocated() / 1e9
        saved = dict(checkpoint.timings)
        assert checkpoint.all_steps(ckpt) == [args.steps]
        # restore into a fresh state on the host (the card holds the live
        # one) and compare leaf by leaf
        live = keep["state"]
        fresh = _fresh_host_state(args.arch)
        t0 = time.perf_counter()
        (params, opt), step = checkpoint.restore(ckpt, fresh)
        restore_s = time.perf_counter() - t0
        assert step == args.steps and opt.step == live[1].step
        leaves = 0
        for (name, got), (_, want) in zip(checkpoint.flatten((params, opt)),
                                          checkpoint.flatten(live)):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want.cpu()), name
            else:
                assert got == want, name
            leaves += 1
        del params, opt, fresh
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [r["loss"] for r in records]
    assert len(records) == args.steps
    assert all(math.isfinite(l) for l in losses), losses
    # every attention layer of every forward and of its recomputation in
    # the backward went blockwise; autograd launches no kernel; AdamW its
    # norm and update once a step, every element through them
    assert blockwise == 2 * cfg.num_layers * args.steps, blockwise
    assert launches == dict(flash_attention=0, chunk_accum=0, ssd_chunk=0,
                            adamw_norm=args.steps,
                            adamw_update=args.steps), launches
    assert adamw_elements == (n_params * args.steps, 0), adamw_elements
    steady = records[1:]
    res = dict(command="repro_torch.launch.train " + " ".join(argv),
               layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, params=n_params, seq=args.seq,
               global_batch=args.global_batch,
               compute_dtype="float32" if args.reduced else "bfloat16",
               params_dtype="float32", losses=losses,
               step_s=[r["seconds"] for r in records],
               tokens_per_step=records[0]["tokens"],
               steady_tok_per_s=sum(r["tokens"] for r in steady)
               / sum(r["seconds"] for r in steady),
               blockwise_calls=blockwise,
               blockwise_calls_expected="2 x layers x steps",
               kernel_launches=launches,
               adamw_elements_kernel_loop=adamw_elements,
               max_memory_allocated_gb=peak,
               wall_s=wall, checkpoint_step=args.steps,
               checkpoint_bytes=saved.get("bytes"),
               checkpoint_leaves=leaves, reduced=None,
               save_to_host_s=saved.get("to_host_s"),
               save_write_s=saved.get("write_s"),
               save_wait_s=saved.get("wait_s"), restore_s=restore_s,
               restore_to="host (the card holds the live state)",
               restored_equal=True,
               host_max_rss_gb=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 1e6)
    emit("train_long", **res)
    del keep, live
    torch.cuda.empty_cache()
    return res


def phase_train_long_vs_cpu(seed: int) -> None:
    seq, steps = 2304, 2
    for name in ("gemma2-2b", "qwen3-8b"):
        t0 = time.perf_counter()
        cfg, losses, calls, cpu, gpu = _train_pair(name, seed, seq, batch=2,
                                                   steps=steps)
        assert all(math.isfinite(lg) for _, lg in losses)
        # forward and recomputation of every layer, on both sides
        assert calls == [2 * cfg.num_layers] * (2 * steps), calls
        loss_err, param_err = _train_errs(losses, cpu, gpu)
        assert loss_err <= TRAIN_LOSS_RTOL, (name, loss_err)
        assert param_err <= TRAIN_PARAM_ATOL, (name, param_err)
        emit("train_long_vs_cpu", arch=name, reduced=True, seq=seq,
             global_batch=2, steps=steps, blockwise_calls_per_step=calls[0],
             max_rel_loss_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
             max_abs_param_err=param_err, param_atol=TRAIN_PARAM_ATOL,
             seconds=time.perf_counter() - t0)


def _supervised_losses(seed: int, ckpt: str, crash_after: int = -1,
                       steps: int = 6) -> list:
    """[(step, loss)] of reduced qwen3-8b on the card under TrainSupervisor
    (a checkpoint every 3 steps); the step function raises once after
    computing step `crash_after`, before the supervisor commits it."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   TrainSupervisor, host_batch_slice,
                                   init_train_state, make_train_step)
    cfg = reduced_config("qwen3-8b")
    model = build_model(cfg, remat=True)
    state = init_train_state(model, seed, DEV)
    train = make_train_step(model, TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps)))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                    seed=seed)
    seen = []

    def step_fn(step, state):
        batch = {k: v.to(DEV) for k, v in
                 host_batch_slice(dc, step, 0, 4).items()}
        params, opt, metrics = train(*state, batch)
        seen.append((step, float(metrics["loss"])))
        if step == crash_after and len(seen) == crash_after + 1:
            raise RuntimeError("injected crash after the step")
        return (params, opt), metrics

    sup = TrainSupervisor(ckpt_dir=ckpt, ckpt_every=3, max_restarts=1)
    _, final = sup.run(state=state, num_steps=steps, step_fn=step_fn,
                       log_every=0, log=lambda line: None)
    assert final == steps
    return seen


def phase_supervisor_restore(seed: int) -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        crashed = _supervised_losses(seed, a, crash_after=4)
        unbroken = _supervised_losses(seed, b)
    steps = [s for s, _ in crashed]
    # steps 0-4, the crash after 4, the restore of step 3's checkpoint
    assert steps == [0, 1, 2, 3, 4, 3, 4, 5], steps
    first, replay = dict(crashed[:5]), crashed[5:]
    ref = dict(unbroken)
    gaps = [abs(loss - first[s]) / abs(first[s]) for s, loss in replay[:2]]
    gaps += [abs(loss - ref[s]) / abs(ref[s]) for s, loss in replay]
    assert max(gaps) <= RESTORE_RTOL, gaps
    emit("supervisor_restore", arch="qwen3-8b", reduced=True, ckpt_every=3,
         crash_after_step=4, steps_run=steps, replayed=replay,
         max_rel_gap=max(gaps), rtol=RESTORE_RTOL,
         seconds=time.perf_counter() - t0)


def _stacked_bucket(seed: int, elems: int) -> torch.Tensor:
    gens = [torch.Generator(device=DEV).manual_seed(seed * 1000 + r)
            for r in range(RANKS)]
    stack = torch.empty((RANKS, elems), device=DEV)
    for r in range(RANKS):
        stack[r].normal_(generator=gens[r])
    return stack


def phase_schedule_cache(seed: int) -> dict:
    from repro_torch.api import Collectives
    from repro_torch.cache import allreduce_to_json
    from repro_torch.comms import BucketedAllReduce, Stacked
    from repro_torch.kernels import CHUNK_ACCUM_KERNEL
    from repro_torch.topo import axis_topology_for_mesh
    stack = _stacked_bucket(seed, (64 << 20) // 4)
    launches = 0
    for label, topo in (("dgx:8", "dgx:8"),
                        ("data-ring8", axis_topology_for_mesh("data",
                                                              RANKS))):
        with tempfile.TemporaryDirectory() as d:
            cold = Collectives(cache=d)
            t0 = time.perf_counter()
            art = cold.schedule(topo, kind="allreduce")
            compile_s = time.perf_counter() - t0
            (path,) = [os.path.join(d, f) for f in os.listdir(d)
                       if f.startswith("allreduce-") and f.endswith(".json")]
            with open(path, "rb") as f:
                stored = f.read()
            warm = Collectives(cache=d)
            t0 = time.perf_counter()
            again = warm.schedule(topo, kind="allreduce")
            hit_s = time.perf_counter() - t0
            stats = warm.cache.stats
            assert (stats.hits, stats.misses) == (1, 0), stats.describe()
            with open(path, "rb") as f:
                assert f.read() == stored
            assert allreduce_to_json(again).encode() == stored
            assert allreduce_to_json(art).encode() == stored
        outs = []
        CHUNK_ACCUM_KERNEL.launches = 0
        for a in (art, again):
            red = BucketedAllReduce.from_schedule(a, Stacked(RANKS),
                                                  wire_dtype=None)
            outs.append(red.reduce_bucket(stack))
        torch.cuda.synchronize()
        n = CHUNK_ACCUM_KERNEL.launches
        assert n > 0, label
        launches += n
        assert torch.equal(outs[0], outs[1]), label
        emit("schedule_cache", topology=label, artifact_bytes=len(stored),
             compile_s=compile_s, hit_s=hit_s, hit_stats=stats.describe(),
             payload_byte_identical=True, bucket_elems_per_rank=stack.shape[1],
             ranks=RANKS, bucket_equal=True, chunk_accum_launches=n)
        del outs
    del stack
    torch.cuda.empty_cache()
    return dict(launches=launches)


def phase_repair_stacked(seed: int) -> dict:
    from repro_torch.comms import CollectiveContext, Stacked
    from repro_torch.kernels import CHUNK_ACCUM_KERNEL
    from repro_torch.topo.spec import TransformSpec
    stack = _stacked_bucket(seed + 1, (64 << 20) // 4)
    ctx = CollectiveContext({"data": RANKS})
    red = ctx.bucketed_allreduce("data", Stacked(RANKS), wire_dtype=None)
    rs_calls = red.rs_prog.num_calls
    before = (red.reduce_bucket(stack) - stack.sum(0)).abs().max().item()
    assert before <= STACK_ATOL, before
    fault = "@fail(0-1)"
    degraded = TransformSpec.parse_text(fault).apply(ctx.topology("data"))
    t0 = time.perf_counter()
    reports = ctx.hot_swap(fault)
    swap_s = time.perf_counter() - t0
    red = ctx.bucketed_allreduce("data", Stacked(RANKS), wire_dtype=None)
    torch.cuda.synchronize()
    CHUNK_ACCUM_KERNEL.launches = 0
    got = red.reduce_bucket(stack)
    torch.cuda.synchronize()
    launches = CHUNK_ACCUM_KERNEL.launches
    assert launches > 0
    cold = CollectiveContext({"data": RANKS}, topologies={"data": degraded})
    ref = cold.bucketed_allreduce("data", Stacked(RANKS),
                                  wire_dtype=None).reduce_bucket(stack)
    assert torch.equal(got, ref)
    err = (got - stack.sum(0)).abs().max().item()
    assert err <= STACK_ATOL, err
    emit("repair_stacked", topology="data-ring8", transform=fault,
         degraded=degraded.name, ranks=RANKS,
         bucket_elems_per_rank=stack.shape[1],
         reports=[dict(axis=a, kind=r.kind, repair_time_s=r.repair_time_s,
                       warm_solve=r.warm_solve, warm_split=r.warm_split,
                       cached=r.cached, verified=r.verified)
                  for a, reps in reports.items() for r in reps],
         hot_swap_s=swap_s, rs_calls_before=rs_calls,
         rs_calls_repaired=red.rs_prog.num_calls,
         max_abs_err_vs_sum_before=before, equal_cold_degraded=True,
         max_abs_err_vs_sum=err, atol=STACK_ATOL,
         repaired_chunk_accum_launches=launches)
    del stack, got, ref
    torch.cuda.empty_cache()
    return dict(launches=launches)


# ---------------------------------------------------------------------- #
# the MoE family and the collectives it adds (phases 22-26)
# ---------------------------------------------------------------------- #

SERVE_PROMPTS = (1000, 613, 1024, 96)   # the serve phase's prompts
# mixtral-8x7b at full width is 46.7 B params (93 GB in bf16): it runs at
# its published width with the depth cut to fit the card beside the rest
MIXTRAL_LAYERS = 4
MOE_A2A = {"qwen2-moe-a2.7b": 4, "mixtral-8x7b": 8}   # stacked ranks
MOE_A2A_TOKENS = (2, 512)              # [B, S] per rank
MOE_ATOL = 1e-5      # fp32 expert-parallel vs per-rank dense dispatch,
#                      relative to the output's largest magnitude (>= 1)
A2A_SPECS = ("bring:4", "bring:8", "fig1a", "dgx:8")
ROOTED_BYTES = 64 << 20                # per rank
ROOTED_ROOTS = (0, 3)


class _RouteRecorder:
    """Wraps `repro_torch.models.moe._route` to keep each call's slots and
    overflow slot, so dropped choices are counted after a run: no launch
    and no sync is added to the run itself."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.calls = moe, moe._route, []

    def __enter__(self):
        def route(p, cfg, xg, cap):
            out = self.orig(p, cfg, xg, cap)
            self.calls.append((xg.shape[1], out[3], cfg.num_experts * cap))
            return out
        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig

    def dropped(self, decode: bool) -> tuple:
        """(dropped choices, routed choices) of prefill (decode=False) or
        decode calls (one token per sequence)."""
        picked = [(slot, over) for t, slot, over in self.calls
                  if (t <= 2) == decode]
        drop = sum(int((slot == over).sum()) for slot, over in picked)
        return drop, sum(slot.numel() for slot, _ in picked)


def _launches_per_decode_token(model, params, prompts, steps: int,
                               extras=None) -> float:
    """cudaLaunchKernel calls per decoded token, from torch.profiler over
    `steps` greedy decode steps of one batch (a count, no timing).
    extras: the batch's stacked frontend embeddings, if its family has
    them."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    with torch.inference_mode():
        state = model.init_decode_state(len(prompts),
                                        prefix + plen + steps + 1,
                                        device=DEV)
        state, logits = model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(DEV),
                     **(extras or {})}, state)
        tok = logits[:, -1].argmax(-1)[:, None]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                logits, state = model.decode_step(params, tok, state,
                                                  prefix + plen + i)
                tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
    n = {e.key: e.count for e in prof.key_averages()}
    return n.get("cudaLaunchKernel", 0) / (steps * len(prompts))


def phase_serve_moe(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_KERNEL
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServingEngine
    results = {"flash_launches": 0}
    for name in ("qwen2-moe-a2.7b", "mixtral-8x7b"):
        full = get_config(name)
        cfg, reduced = full, None
        if name == "mixtral-8x7b":
            cfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
            reduced = {"num_layers": [full.num_layers, MIXTRAL_LAYERS]}
        model = build_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(seed, torch.bfloat16, DEV)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in params.parameters())
        new_tokens, batch_size = 16, 2
        engine = ServingEngine(model, params, batch_size=batch_size,
                               max_len=2048)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
                   for n in SERVE_PROMPTS]
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
        n_batches = -(-len(prompts) // batch_size)

        with _RouteRecorder() as rec:
            FLASH_KERNEL.launches = 0
            t0 = time.perf_counter()
            outs = engine.run()
            wall_s = time.perf_counter() - t0
            flash = FLASH_KERNEL.launches
        assert [o.uid for o in outs] == list(range(len(prompts)))
        for o, p in zip(outs, prompts):
            assert o.prompt_len == len(p)
            assert len(o.tokens) == len(p) + new_tokens
            assert (o.tokens[:len(p)] == p).all()
            new = o.tokens[len(p):]
            assert ((new >= 0) & (new < cfg.vocab_size)).all()
        assert flash == cfg.num_layers * n_batches, (name, flash)
        assert len(rec.calls) == cfg.num_layers * n_batches * new_tokens
        drop_p, routed_p = rec.dropped(decode=False)
        drop_d, routed_d = rec.dropped(decode=True)
        del rec
        st = engine.stats
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the first batch's prefill logits: finite, of the expected shape
        with torch.inference_mode():
            toks = torch.from_numpy(np.stack(
                [prompts[0], np.pad(prompts[1], (len(prompts[0])
                                                 - len(prompts[1]), 0))]
            ).astype(np.int64)).to(DEV)
            _, logits = model.prefill(params, {"tokens": toks},
                                      model.init_decode_state(
                                          2, len(prompts[0]) + 1,
                                          device=DEV))
        assert logits.shape == (2, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        launches = _launches_per_decode_token(model, params, prompts[:2], 8)
        res = dict(arch=name, family=cfg.family, layers=cfg.num_layers,
                   d_model=cfg.d_model, experts=cfg.num_experts,
                   top_k=cfg.num_experts_per_tok,
                   shared_experts=cfg.num_shared_experts,
                   reduced=reduced, dtype="bfloat16", params=n_params,
                   init_s=init_s, prompts=list(SERVE_PROMPTS),
                   batch_size=batch_size, new_tokens=new_tokens,
                   batches=n_batches, wall_s=wall_s,
                   prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                   prefill_tokens=st["prefill_tokens"],
                   decode_tokens=st["decode_tokens"],
                   prefill_tok_per_s=st["prefill_tokens"] / st["prefill_s"],
                   decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
                   flash_launches=flash,
                   moe_dropped_choices_prefill=drop_p,
                   moe_routed_choices_prefill=routed_p,
                   moe_dropped_choices_decode=drop_d,
                   moe_routed_choices_decode=routed_d,
                   launches_per_decoded_token=launches,
                   max_memory_allocated_gb=peak_gb,
                   completions=[[int(t) for t in o.tokens[o.prompt_len:]]
                                for o in outs])
        emit("serve_moe", **res)
        results[name] = res
        results["flash_launches"] += flash
        del engine, params, logits
    torch.cuda.empty_cache()
    return results


def phase_moe_entry_point() -> None:
    t0 = time.perf_counter()
    cmd = ["-m", "repro_torch.launch.serve", "--arch", "qwen2-moe-a2.7b",
           "--reduced"]
    proc = subprocess.run(
        [sys.executable, *cmd], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    served = [l for l in proc.stdout.splitlines() if l.startswith("req ")]
    assert len(served) == 6, proc.stdout
    emit("moe_entry_point", command="python " + " ".join(cmd),
         rc=proc.returncode, requests=len(served),
         seconds=time.perf_counter() - t0)


def _moe_layer(name: str, seed: int, dtype):
    """One MoE block of `name` at full width on the card, random weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(name)
    with torch.device("meta"):
        layer = moe.MoE(cfg, dtype)
    layer = layer.to_empty(device=DEV)
    moe.init_moe(layer, cfg, torch.Generator(device=DEV).manual_seed(seed))
    return cfg, layer


def phase_alltoall_stacked(seed: int) -> None:
    import functools
    from repro_torch.api import Collectives
    from repro_torch.comms import CollectiveContext, Stacked, tree_all_to_all
    from repro_torch.models import moe
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cc = Collectives(num_chunks=1)
    for spec in A2A_SPECS:
        prog = cc.program(spec, kind="alltoall")
        a = prog.axis_size
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(a, a, 257, 33, generator=gen, device=DEV
                            ).to(dtype)
            y = tree_all_to_all(x, prog, Stacked(a))
            assert torch.equal(y, x.transpose(0, 1)), (spec, dtype)
        emit("alltoall_stacked", topology=spec, ranks=a,
             block=[257, 33], dtypes=["float32", "bfloat16"],
             calls=prog.num_calls, slots_per_shard=prog.slots_per_shard,
             equal_transpose=True)
    for name, a in MOE_A2A.items():
        ctx = CollectiveContext({"data": a})
        prog = ctx.alltoall_program("data")
        comm = Stacked(a)
        tree = functools.partial(tree_all_to_all, prog=prog, comm=comm)
        b, s = MOE_A2A_TOKENS
        out = {}
        for dtype in (torch.bfloat16, torch.float32):
            cfg, layer = _moe_layer(name, seed, dtype)
            x = torch.randn(a, b, s, cfg.d_model, generator=gen,
                            device=DEV).to(dtype)
            with torch.inference_mode():
                y, aux = moe.moe_forward_alltoall(layer, cfg, x, comm)
                y_tree, aux_tree = moe.moe_forward_alltoall(
                    layer, cfg, x, comm, all_to_all=tree)
                assert torch.equal(y, y_tree) and torch.equal(aux, aux_tree)
                if dtype == torch.float32:
                    worst, scale = 0.0, 1.0
                    for r in range(a):
                        y_loc, _ = moe.moe_forward(layer, cfg, x[r])
                        scale = max(scale, y_loc.abs().max().item())
                        worst = max(worst,
                                    (y[r] - y_loc).abs().max().item())
                    assert worst <= MOE_ATOL * scale, (name, worst, scale)
                    out.update(max_abs_err_vs_per_rank=worst,
                               output_scale=scale)
                else:
                    # the dispatch buffer, timed under both transports
                    t = b * s
                    cap = moe._capacity(t, cfg)
                    el = cfg.num_experts // a
                    buf = torch.randn(a, a, el * cap, cfg.d_model,
                                      generator=gen, device=DEV).to(dtype)
                    out.update(
                        dispatch_buffer=[a, a, el * cap, cfg.d_model],
                        tree_ms=cuda_ms(lambda: tree(buf), iters=10),
                        transpose_ms=cuda_ms(
                            lambda: buf.transpose(0, 1).contiguous(),
                            iters=10))
                    del buf
            del layer, x, y, y_tree
            torch.cuda.empty_cache()
        emit("alltoall_stacked", arch=name, ranks=a,
             topology=ctx.topology("data").name,
             tokens_per_rank=list(MOE_A2A_TOKENS), calls=prog.num_calls,
             slots_per_shard=prog.slots_per_shard,
             bf16_tree_equal_transpose=True, fp32_atol=MOE_ATOL, **out)


def phase_rooted_stacked(seed: int) -> dict:
    from repro_torch.comms import (CollectiveContext, Stacked,
                                   tree_broadcast, tree_reduce)
    from repro_torch.kernels import (CHUNK_ACCUM_KERNEL,
                                     chunk_accum_indexed_reference)
    stack = _stacked_bucket(seed + 2, ROOTED_BYTES // 4)
    ctx = CollectiveContext({"data": RANKS})
    topo = ctx.topology("data")
    comm = Stacked(RANKS)
    plain = Stacked(RANKS, accumulate=chunk_accum_indexed_reference)
    launches = 0
    for root in ROOTED_ROOTS:
        bc = ctx.broadcast_program("data", root)
        rd = ctx.collectives.program(topo, kind="reduce", root=root)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tree_broadcast(stack, bc, comm)
        torch.cuda.synchronize()
        bc_s = time.perf_counter() - t0
        for r in range(RANKS):
            assert torch.equal(out[r], stack[root]), (root, r)
        del out
        CHUNK_ACCUM_KERNEL.launches = 0
        t0 = time.perf_counter()
        got = tree_reduce(stack, rd, comm)[root].clone()
        torch.cuda.synchronize()
        rd_s = time.perf_counter() - t0
        n = CHUNK_ACCUM_KERNEL.launches
        assert n > 0, root
        launches += n
        ref = tree_reduce(stack, rd, plain)[root]
        assert torch.equal(got, ref), root
        err = (got - stack.sum(0)).abs().max().item()
        assert err <= STACK_ATOL, (root, err)
        emit("rooted_stacked", topology=topo.name, root=root, ranks=RANKS,
             bytes_per_rank=ROOTED_BYTES, broadcast_calls=bc.num_calls,
             reduce_calls=rd.num_calls, broadcast_s=bc_s, reduce_s=rd_s,
             broadcast_equal_root=True, reduce_bit_equal_plain=True,
             max_abs_err_vs_sum=err, atol=STACK_ATOL,
             chunk_accum_launches=n)
        del got, ref
        torch.cuda.empty_cache()
    del stack
    torch.cuda.empty_cache()
    return dict(launches=launches)


# ---------------------------------------------------------------------- #
# every family builds, serves and trains (phases 27-32)
# ---------------------------------------------------------------------- #

VLM_PROMPTS = (512, 300, 512, 64)      # text tokens; each adds 256 patches
AUDIO_PROMPTS = (128, 64, 200, 16)     # decoder tokens; each 1500 frames
# qwen2-moe-a2.7b's fp32 masters, grads and AdamW state at its full 24
# layers are ~229 GB: it trains at its published width with 4 layers
MOE_TRAIN_LAYERS = 4
# (arch, global batch, --seq in text tokens, layers kept or None);
# sequences are multiples of the SSM chunk (512, 256), so the chunked scan;
# mamba2-780m at the benchmark cell's 2 x 4096
TRAIN_FAMILIES = [("mamba2-780m", 2, 4096, None),
                  ("zamba2-1.2b", 2, 1024, None),
                  ("paligemma-3b", 2, 512, None),
                  ("whisper-medium", 2, 448, None),
                  ("qwen2-moe-a2.7b", 2, 1024, MOE_TRAIN_LAYERS)]
FAMILY_NAMES = ("mamba2-780m", "zamba2-1.2b", "qwen2-moe-a2.7b",
                "paligemma-3b", "whisper-medium")


def _flash_per_prefill(cfg) -> int:
    """Flash launches in one prefill: one per attention layer; whisper's
    encoder layer, decoder self-attention and cross-attention each."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _stacked_frontend(cfg, seed: int, uids, device, dtype=torch.float32):
    """The serve launcher's stub frontend output of requests `uids`,
    stacked into a batch's feed ({} for a family without one)."""
    from repro_torch.launch.serve import frontend_stub
    stubs = [frontend_stub(cfg, seed, u) for u in uids]
    if stubs[0] is None:
        return {}
    return {k: torch.from_numpy(np.stack([x[k] for x in stubs])).to(
        device, dtype) for k in stubs[0]}


def phase_families_vs_cpu(seed: int) -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import FLASH_KERNEL
    from repro_torch.models import build_model
    for name in ("paligemma-3b", "whisper-medium"):
        cfg = reduced_config(name)
        model = build_model(cfg)
        cpu = model.init(seed, torch.float32, "cpu")
        gpu = copy.deepcopy(cpu).to(DEV)
        rng = np.random.default_rng(seed)
        b, s = 2, 77
        prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
        max_len = prefix + s + 8
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int64))
        extras = _stacked_frontend(cfg, seed, range(b), "cpu")
        before = FLASH_KERNEL.launches
        worst = 0.0
        with torch.inference_mode():
            sc, lc = model.prefill(cpu, {"tokens": tokens, **extras},
                                   model.init_decode_state(b, max_len,
                                                           device="cpu"))
            sg, lg = model.prefill(
                gpu, {"tokens": tokens.to(DEV),
                      **{k: v.to(DEV) for k, v in extras.items()}},
                model.init_decode_state(b, max_len, device=DEV))
            launched = FLASH_KERNEL.launches - before
            for index in range(prefix + s, prefix + s + 4):
                worst = max(worst, (lg.cpu() - lc).abs().max().item())
                tok = lc[:, -1].argmax(-1)[:, None]
                lc, sc = model.decode_step(cpu, tok, sc, index)
                lg, sg = model.decode_step(gpu, tok.to(DEV), sg, index)
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
        assert torch.isfinite(lg).all()
        assert launched == _flash_per_prefill(cfg) > 0, (name, launched)
        assert worst <= MODEL_ATOL, (name, worst)
        emit("families_vs_cpu", arch=name, reduced=True, prompt=[b, s],
             frontend_rows=prefix or cfg.encoder_seq, decode_steps=4,
             max_abs_logit_err=worst, atol=MODEL_ATOL,
             flash_launches_in_prefill=launched)


class _DeviceSeconds:
    """Wraps `module.name` so each call is timed between two
    synchronisations of the card (adds two syncs per call)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_serve_family(seed: int, name: str, plens, phase: str) -> dict:
    """Serving path of the vlm or audio family at full width: requests with
    the stub frontend's embeddings through ServingEngine, batch 2, 16 new
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import FLASH_KERNEL
    from repro_torch.launch.serve import frontend_stub
    from repro_torch.models import build_model, encdec
    from repro_torch.serve import Request, ServingEngine
    cfg = get_config(name)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, torch.bfloat16, DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    new_tokens, batch_size = 16, 2
    engine = ServingEngine(model, params, batch_size=batch_size,
                           max_len=2048)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
               for n in plens]
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens,
                              extras=frontend_stub(cfg, seed, i)))
    n_batches = -(-len(prompts) // batch_size)

    with _DeviceSeconds(encdec, "encode") as enc:
        FLASH_KERNEL.launches = 0
        t0 = time.perf_counter()
        outs = engine.run()
        wall_s = time.perf_counter() - t0
        flash = FLASH_KERNEL.launches
    assert [o.uid for o in outs] == list(range(len(prompts)))
    for o, p in zip(outs, prompts):
        assert o.prompt_len == len(p)
        assert len(o.tokens) == len(p) + new_tokens
        assert (o.tokens[:len(p)] == p).all()
        new = o.tokens[len(p):]
        assert ((new >= 0) & (new < cfg.vocab_size)).all()
    # one launch per attention call of each prefill; decode takes the
    # direct path
    assert flash == _flash_per_prefill(cfg) * n_batches, (name, flash)
    assert len(enc.seconds) == (n_batches if cfg.family == "audio" else 0)
    st = engine.stats
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the first batch's prefill logits: finite, of the expected shape
    extras = _stacked_frontend(cfg, seed, (0, 1), DEV, torch.bfloat16)
    prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
    with torch.inference_mode():
        toks = torch.from_numpy(np.stack(
            [prompts[0], np.pad(prompts[1], (len(prompts[0])
                                             - len(prompts[1]), 0))]
        ).astype(np.int64)).to(DEV)
        _, logits = model.prefill(params, {"tokens": toks, **extras},
                                  model.init_decode_state(
                                      2, prefix + len(prompts[0]) + 1,
                                      device=DEV))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    launches = _launches_per_decode_token(model, params, prompts[:2], 8,
                                          extras)
    frontend = ({"patch_embed": cfg.num_image_tokens} if prefix
                else {"audio_embed": cfg.encoder_seq})
    res = dict(arch=name, family=cfg.family, layers=cfg.num_layers,
               encoder_layers=cfg.encoder_layers or None,
               d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads],
               head_dim=cfg.hd, vocab=cfg.vocab_size, reduced=None,
               dtype="bfloat16", params=n_params, init_s=init_s,
               frontend_rows_per_request=frontend, prompts=list(plens),
               batch_size=batch_size, new_tokens=new_tokens,
               batches=n_batches, wall_s=wall_s,
               prefill_s=st["prefill_s"], decode_s=st["decode_s"],
               prefill_positions=st["prefill_tokens"],
               prefill_positions_count="decoder positions, the vlm's "
                                       "patch rows included",
               decode_tokens=st["decode_tokens"],
               prefill_pos_per_s=st["prefill_tokens"] / st["prefill_s"],
               decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
               flash_launches=flash,
               launches_per_decoded_token=launches,
               max_memory_allocated_gb=peak_gb,
               completions=[[int(t) for t in o.tokens[o.prompt_len:]]
                            for o in outs])
    if cfg.family == "audio":
        res.update(encoder_s=enc.seconds,
                   decoder_prefill_s=st["prefill_s"] - sum(enc.seconds),
                   encoder_frames_per_s=n_batches * batch_size
                   * cfg.encoder_seq / sum(enc.seconds),
                   encoder_timing="each encode between two syncs of the "
                                  "card, inside prefill_s")
    emit(phase, **res)
    del engine, params, logits
    torch.cuda.empty_cache()
    return res


class _SkipCheckpointWrites:
    """The supervisor's checkpoint writes recorded, not made: phases 9 and
    17 measure them; here they would write ~100 GB for nothing."""

    def __enter__(self):
        from repro_torch.train import checkpoint
        self.mod, self.orig, self.steps = checkpoint, checkpoint.save_async, []
        checkpoint.save_async = lambda d, step, tree: self.steps.append(step)
        return self

    def __exit__(self, *exc):
        self.mod.save_async = self.orig


def phase_train_families(seed: int) -> dict:
    """`launch.train.run` of each family at full width, 3 steps, with
    every kernel's launches a step: under autograd attention takes its
    plain path, the chunked SSD its kernels (the block's and the state
    passes' forward twice a Mamba2 layer with remat, their backward once),
    and no plain version of any of its four steps runs; AdamW takes its
    kernel (one norm and one update launch a step, every element counted
    on its path, none on the loop's)."""
    import repro_torch.configs as configs
    from repro_torch.kernels import (CHUNK_ACCUM_KERNEL, FLASH_KERNEL,
                                     SSD_BWD_KERNEL, SSD_KERNEL,
                                     SSD_STATE_BWD_KERNEL, SSD_STATE_KERNEL,
                                     adamw, ssd_scan, ssd_state)
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import UPDATED
    kernels = {"flash_attention": FLASH_KERNEL, "ssd_chunk": SSD_KERNEL,
               "ssd_chunk_bwd": SSD_BWD_KERNEL, "ssd_state": SSD_STATE_KERNEL,
               "ssd_state_bwd": SSD_STATE_BWD_KERNEL,
               "chunk_accum": CHUNK_ACCUM_KERNEL,
               "adamw_norm": adamw.NORM_KERNEL,
               "adamw_update": adamw.UPDATE_KERNEL}
    get_config = configs.get_config
    # the plain versions of all four steps, forward and backward: none runs
    plain = [(ssd_scan, "ssd_chunk_intra_heads_reference"),
             (ssd_scan, "ssd_chunk_intra_bwd_reference"),
             (ssd_state, "ssd_state_reference"),
             (ssd_state, "ssd_state_bwd_reference")]
    originals = [getattr(mod, name) for mod, name in plain]
    plain_calls = []

    def counting(fn):
        def counted(*args, **kw):
            plain_calls.append(fn.__name__)
            return fn(*args, **kw)
        return counted
    out, launches = {}, {k: 0 for k in kernels}
    for name, batch, seq, layers in TRAIN_FAMILIES:
        full = get_config(name)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        argv = ["--arch", name, "--steps", "3", "--global-batch", str(batch),
                "--seq", str(seq), "--device", DEV, "--seed", str(seed)]
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_families_")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        configs.get_config = lambda n: cfg if n == name else get_config(n)
        for (mod, attr), fn in zip(plain, originals):
            setattr(mod, attr, counting(fn))
        plain_calls.clear()
        before = {k: kn.launches for k, kn in kernels.items()}
        updated = UPDATED.kernel, UPDATED.loop
        t0 = time.perf_counter()
        try:
            keep = {}
            with _SkipCheckpointWrites() as skipped:
                records = launch_train.run(launch_train.build_parser()
                                           .parse_args(argv + ["--ckpt-dir",
                                                               ckpt]),
                                           keep=keep)
            n_params = sum(p.numel() for p in keep["state"][0].parameters())
            del keep
        finally:
            configs.get_config = get_config
            for (mod, attr), fn in zip(plain, originals):
                setattr(mod, attr, fn)
            shutil.rmtree(ckpt, ignore_errors=True)
        wall = time.perf_counter() - t0
        per_step = {k: (kn.launches - before[k]) / len(records)
                    for k, kn in kernels.items()}
        for k in kernels:
            launches[k] += kernels[k].launches - before[k]
        mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
        assert per_step == {"flash_attention": 0, "ssd_chunk": 2 * mamba,
                            "ssd_chunk_bwd": mamba, "ssd_state": 2 * mamba,
                            "ssd_state_bwd": mamba, "chunk_accum": 0,
                            "adamw_norm": 1, "adamw_update": 1}, \
            (name, per_step)
        adamw_elements = (UPDATED.kernel - updated[0],
                          UPDATED.loop - updated[1])
        assert adamw_elements == (n_params * len(records), 0), \
            (name, adamw_elements)
        assert not plain_calls, (name, len(plain_calls))
        losses = [r["loss"] for r in records]
        assert len(records) == 3 and all(math.isfinite(l) for l in losses), \
            (name, losses)
        aux = [r["loss"] - r["token_loss"] for r in records]
        assert (min(aux) > 0) == bool(cfg.num_experts), (name, aux)
        frontend = cfg.num_image_tokens or (cfg.encoder_seq
                                            if cfg.is_encoder_decoder else 0)
        steady = records[1:]
        res = dict(arch=name, family=cfg.family, layers=cfg.num_layers,
                   d_model=cfg.d_model,
                   reduced=None if layers is None
                   else {"num_layers": [full.num_layers, layers]},
                   params=n_params, compute_dtype="bfloat16",
                   params_dtype="float32", optimizer="AdamW", remat=True,
                   global_batch=batch, text_tokens=seq,
                   frontend_rows=frontend, losses=losses,
                   token_losses=[r["token_loss"] for r in records],
                   moe_aux_term=aux, step_s=[r["seconds"] for r in records],
                   steady_text_tok_per_s=sum(r["tokens"] for r in steady)
                   / sum(r["seconds"] for r in steady),
                   steady_positions_per_s=batch * (seq + frontend)
                   * len(steady) / sum(r["seconds"] for r in steady),
                   launches_per_step=per_step,
                   adamw_elements_kernel_loop=adamw_elements,
                   plain_ssd_calls=len(plain_calls),
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9, wall_s=wall,
                   checkpoint_writes_skipped_at_steps=skipped.steps)
        emit("train_families", **res)
        out[name] = res
    # one rank, no collective
    out["launches"] = launches
    emit("train_families_launches", **out["launches"])
    torch.cuda.empty_cache()
    return out


def phase_train_families_vs_cpu(seed: int) -> None:
    for name in FAMILY_NAMES:
        t0 = time.perf_counter()
        cfg, losses, _, cpu, gpu = _train_pair(name, seed, seq=64, batch=4,
                                               steps=2)
        assert all(math.isfinite(lg) for _, lg in losses)
        loss_err, param_err = _train_errs(losses, cpu, gpu)
        assert loss_err <= TRAIN_LOSS_RTOL, (name, loss_err)
        assert param_err <= TRAIN_PARAM_ATOL, (name, param_err)
        emit("train_families_vs_cpu", arch=name, reduced=True, seq=64,
             global_batch=4, steps=2, max_rel_loss_err=loss_err,
             loss_rtol=TRAIN_LOSS_RTOL, max_abs_param_err=param_err,
             param_atol=TRAIN_PARAM_ATOL, seconds=time.perf_counter() - t0)


def phase_families_entry_point() -> None:
    """The launchers with no --device flag, all started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmds = [["-m", "repro_torch.launch.serve", "--arch", a, "--reduced"]
            for a in ("paligemma-3b", "whisper-medium")]
    cmds += [["-m", "repro_torch.launch.train", "--arch", a, "--reduced",
              "--steps", "2"] for a in FAMILY_NAMES]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, cmd in enumerate(cmds):
            extra = ["--ckpt-dir", os.path.join(tmp, str(i))] \
                if "repro_torch.launch.train" in cmd else []
            procs.append(subprocess.Popen(
                [sys.executable, *cmd, *extra], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        assert p.returncode == 0, (cmd, err[-3000:])
        lines = out.splitlines()
        if "repro_torch.launch.serve" in cmd:
            assert sum(l.startswith("req ") for l in lines) == 6, out
        else:
            assert re.fullmatch(r"done at step 2; stragglers: \d+; link "
                                r"faults repaired: False", lines[-1]), out
    emit("families_entry_point",
         commands=["python " + " ".join(c) for c in cmds],
         rcs=[p.returncode for p in procs],
         seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------- #
# the model axis (phases 33-34)
# --------------------------------------------------------------------- #

MESH1_TRAIN_STEPS = 2
ADAMW_SPY_EVERY = 4    # phase 33's kernel leg: every 4th tensor held
CARDS_ARGV: list = []         # flags added to every run of phase 34
MESH1_LOGITS_ATOL = 2e-2      # bf16, the flash tolerance, if not torch.equal
RANK_BYTES = [("mixtral-8x7b", {"data": 1, "model": 2}, False),
              ("mixtral-8x7b", {"data": 1, "model": 4}, False),
              ("qwen3-8b", {"data": 2, "model": 2}, True)]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _first_logits(model, params, prompts) -> torch.Tensor:
    """fp32 last-position logits of a prefill of `prompts` (left-padded
    with 0, as the engine pads), read whole from DTensor params."""
    from torch.distributed.tensor import DTensor
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    with torch.inference_mode():     # as the engine runs
        state = model.init_decode_state(len(prompts), plen + 1,
                                        device=params.embed.device)
        if isinstance(params.embed, DTensor):
            from repro_torch.launch.mesh import mesh_axis_sizes
            from repro_torch.launch.sharding import (decode_state_specs,
                                                     distribute_tree)
            mesh = params.embed.device_mesh
            state = distribute_tree(state, mesh, decode_state_specs(
                state, model.cfg, mesh_axis_sizes(mesh)))
        _, logits = model.prefill(params, {"tokens": torch.from_numpy(
            toks).to(params.embed.device)}, state)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        return logits.float().clone()


def _rank_bytes() -> list:
    """Per-rank bytes of the placements, reckoned on the meta device:
    serving's bf16 params (TP) and training's fp32 masters + AdamW moments
    (FSDP+TP, 12 bytes a param)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import _MODULES
    from repro_torch.launch.sharding import local_bytes, param_specs
    out = []
    for name, sizes, fsdp in RANK_BYTES:
        cfg = get_config(name)
        with torch.device("meta"):
            module = _MODULES[cfg.family](cfg, torch.bfloat16)
        specs = param_specs(module, sizes, fsdp=fsdp)
        per = 12 if fsdp else 2
        total = sum(p.numel() for p in module.parameters())
        local = sum(local_bytes(p.shape, specs[n], sizes, per)
                    for n, p in module.named_parameters())
        out.append(dict(arch=name, mesh=sizes, fsdp=fsdp,
                        bytes_per_param=per, params=total,
                        whole_gb=total * per / 1e9, per_rank_gb=local / 1e9))
    return out


def _serve_both(args, mesh, prompts, model, kernels) -> dict:
    """`launch.serve.serve` of `prompts` on the plain path and on `mesh`,
    each with every kernel's count from 0: per path its launches, rates,
    peak memory and new tokens; then the first batch's prefill logits of
    both compared (torch.equal, else within MESH1_LOGITS_ATOL) and the
    tokens asserted equal."""
    from repro_torch.launch import serve as launch_serve
    serve = {}
    for path in ("plain", "mesh"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        engine, done = launch_serve.serve(
            args, mesh=mesh if path == "mesh" else None, prompts=prompts)
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        st = engine.stats
        serve[path] = dict(
            wall_s=wall, launches=launches,
            prefill_s=st["prefill_s"], decode_s=st["decode_s"],
            prefill_tok_per_s=st["prefill_tokens"] / st["prefill_s"],
            decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated()
            / 1e9,
            tokens=[[int(t) for t in c.tokens[c.prompt_len:]]
                    for c in done],
            logits=_first_logits(model, engine.params,
                                 prompts[:args.batch_size]).cpu())
        del engine, done
    la, lb = serve["plain"].pop("logits"), serve["mesh"].pop("logits")
    assert torch.isfinite(lb).all()
    logits_equal = torch.equal(la, lb)
    logits_err = float((la - lb).abs().max())
    assert logits_equal or logits_err <= MESH1_LOGITS_ATOL, logits_err
    assert serve["mesh"]["tokens"] == serve["plain"]["tokens"]
    torch.cuda.empty_cache()
    return dict(serve=serve, tokens_equal=True,
                first_logits_equal=logits_equal,
                first_logits_max_abs_diff=logits_err)


class _AdamWSpy:
    """Around every `adamw_update` of the train step (`train_step`'s name
    for it): the gradients' float64 norm, then, after the update, every
    ADAMW_SPY_EVERY-th parameter's p, mu and nu, copied before it, updated
    by the loop from the clip scale of the update's own norm.  `calls`: per
    update the norm, its float64 sum and the tensors held, and the names of
    those not torch.equal to the loop's."""

    def __enter__(self):
        from repro_torch.train import optimizer as opt
        from repro_torch.train import train_step
        self.calls, self._mod = [], train_step
        real = self._real = train_step.adamw_update

        def spy(cfg, grads, state, params):
            named = list(params.named_parameters())[::ADAMW_SPY_EVERY]
            ref = math.sqrt(sum(float(c.double().square().sum())
                                for g in grads.values()
                                for c in g.detach().reshape(-1).split(
                                    1 << 24)))
            copies = [(n, p.detach().clone(), state.mu[n].clone(),
                       state.nu[n].clone()) for n, p in named]
            lr = opt.lr_schedule(cfg, state.step)
            b1c, b2c = opt._bias_corrections(cfg, state.step + 1)
            out = real(cfg, grads, state, params)
            gnorm = out[2]["grad_norm"]
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            unequal = []
            for (n, p), (_, lp, mu, nu) in zip(named, copies):
                opt._loop(cfg, {n: grads[n]}, opt.AdamWState(
                    0, {n: mu}, {n: nu}), [(n, lp)], scale, lr, b1c, b2c)
                for key, a, b in (("p", p, lp), ("mu", state.mu[n], mu),
                                  ("nu", state.nu[n], nu)):
                    if not torch.equal(a, b):
                        unequal.append([n, key])
            self.calls.append(dict(gnorm=float(gnorm), float64=ref,
                                   held=len(copies), unequal=unequal))
            return out
        train_step.adamw_update = spy
        return self

    def __exit__(self, *exc):
        self._mod.adamw_update = self._real


def _train_both(argv: list, mesh, kernels) -> dict:
    """`launch.train.run` of `argv` on the plain path and on `mesh` (FSDP+TP
    placements), each with every kernel's count from 0: losses within
    TRAIN_LOSS_RTOL of each other, finite, the same launches on both, and
    no flash or chunk_accum launch (under autograd attention takes its
    plain path; the SSD block its forward and backward kernels).  Both run
    AdamW's loop: the plain path with `optimizer._on_kernel` patched, since
    the kernel's clip scale is the correctly rounded norm, one float32 ulp
    from `global_norm`'s on gemma2-2b, and two bf16 steps turn that ulp
    into a 4.6e-5 gap of the second loss.  The plain path on the kernel,
    its default, runs too (`plain_kernel`) and is held to what it must
    give: a norm and an update launch a step and none on the loop legs,
    every element through the kernel, the first loss equal to the loop
    leg's (nothing updated yet), the first norm within half a float32 ulp
    of the gradients' float64 norm and so no farther from `global_norm`'s
    than that ulp and `global_norm`'s own error, and at every step the
    kernel's norm within ADAMW_NORM_RTOL of float64 and every
    ADAMW_SPY_EVERY-th tensor's p, mu and nu torch.equal to the loop's
    from the kernel's scale (`_AdamWSpy`)."""
    from repro_torch.kernels import adamw
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer
    kernels = dict(kernels, adamw_norm=adamw.NORM_KERNEL,
                   adamw_update=adamw.UPDATE_KERNEL)
    train = {}
    on_kernel = optimizer._on_kernel
    for path in ("plain_kernel", "plain", "mesh"):
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_mesh1_")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        updated = optimizer.UPDATED.kernel, optimizer.UPDATED.loop
        if path == "plain":
            optimizer._on_kernel = lambda named: False
        spy = _AdamWSpy() if path == "plain_kernel" else \
            contextlib.nullcontext()
        keep = {}
        try:
            with _SkipCheckpointWrites(), spy:
                records = launch_train.run(
                    launch_train.build_parser().parse_args(
                        argv + ["--ckpt-dir", ckpt]),
                    keep=keep, mesh=mesh if path == "mesh" else None)
            n_params = sum(p.numel() for p in keep["state"][0].parameters())
            del keep
        finally:
            optimizer._on_kernel = on_kernel
            shutil.rmtree(ckpt, ignore_errors=True)
        train[path] = dict(
            launches={name: k.launches for name, k in kernels.items()},
            losses=[r["loss"] for r in records],
            grad_norms=[r["grad_norm"] for r in records],
            adamw_elements_kernel_loop=(
                optimizer.UPDATED.kernel - updated[0],
                optimizer.UPDATED.loop - updated[1]),
            step_s=[r["seconds"] for r in records],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated()
            / 1e9)
        if path == "plain_kernel":
            train[path]["adamw_calls"] = spy.calls
            train[path]["params"] = n_params
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(
        train["plain"]["losses"], train["mesh"]["losses"]))
    assert all(math.isfinite(l) for l in train["mesh"]["losses"])
    assert train["mesh"]["launches"] == train["plain"]["launches"]
    assert not train["mesh"]["launches"]["flash_attention"] and \
        not train["mesh"]["launches"]["chunk_accum"]
    assert not train["plain"]["launches"]["adamw_norm"] and \
        not train["plain"]["launches"]["adamw_update"]
    assert loss_err <= TRAIN_LOSS_RTOL, loss_err
    torch.cuda.empty_cache()
    kernel, plain = train["plain_kernel"], train["plain"]
    steps = len(kernel["losses"])
    assert kernel["launches"] == dict(plain["launches"], adamw_norm=steps,
                                      adamw_update=steps), kernel["launches"]
    assert kernel["adamw_elements_kernel_loop"] == \
        (kernel["params"] * steps, 0), kernel["adamw_elements_kernel_loop"]
    assert kernel["losses"][0] == plain["losses"][0], \
        (kernel["losses"], plain["losses"])
    calls = kernel["adamw_calls"]
    assert len(calls) == steps and all(
        c["held"] and not c["unequal"] for c in calls), calls
    assert all(abs(c["gnorm"] - c["float64"]) <= ADAMW_NORM_RTOL
               * c["float64"] for c in calls), calls
    ref = calls[0]["float64"]
    half_ulp = float(np.spacing(np.float32(ref))) / 2
    assert abs(kernel["grad_norms"][0] - plain["grad_norms"][0]) <= \
        abs(plain["grad_norms"][0] - ref) + half_ulp, (calls[0], plain)
    assert all(math.isfinite(l) for l in kernel["losses"])
    return dict(max_rel_loss_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
                **train)


# the ssm and hybrid families on the 1 x 1 mesh: prompts whose padded
# length is the config's chunk, so every prefill takes the SSD kernel
MESH1_SSM = {"mamba2-780m": (512, 512), "zamba2-1.2b": (256, 256)}
MESH1_SSM_NEW_TOKENS = 8
MESH1_SSM_TRAIN = ["--arch", "mamba2-780m", "--steps", "1",
                   "--global-batch", "2", "--seq", "512"]


def phase_model_parallel_mesh1(seed: int) -> dict:
    """qwen3-8b, mamba2-780m and zamba2-1.2b served and gemma2-2b and
    mamba2-780m trained through the placed path on a 1 x 1 ("data",
    "model") mesh (NCCL at world 1, every param a DTensor), each beside
    the plain path in the same call."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import (CHUNK_ACCUM_KERNEL, FLASH_KERNEL,
                                     SSD_BWD_KERNEL, SSD_KERNEL,
                                     SSD_STATE_BWD_KERNEL, SSD_STATE_KERNEL)
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import num_shared_sites
    kernels = {"flash_attention": FLASH_KERNEL,
               "chunk_accum": CHUNK_ACCUM_KERNEL, "ssd_chunk": SSD_KERNEL,
               "ssd_chunk_bwd": SSD_BWD_KERNEL, "ssd_state": SSD_STATE_KERNEL,
               "ssd_state_bwd": SSD_STATE_BWD_KERNEL}
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, 1, DEV)
        cfg = get_config("qwen3-8b")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab_size, n, dtype=np.int32)
                   for n in SERVE_PROMPTS]
        args = launch_serve.build_parser().parse_args(
            ["--arch", cfg.name, "--device", DEV, "--seed", str(seed),
             "--batch-size", "2", "--new-tokens", "16", "--max-len", "2048"])
        batches = -(-len(prompts) // args.batch_size)
        served = _serve_both(args, mesh, prompts, build_model(cfg), kernels)
        for path in served["serve"]:  # flash once per layer per prefill
            assert served["serve"][path]["launches"] == {
                "flash_attention": cfg.num_layers * batches,
                "chunk_accum": 0, "ssd_chunk": 0, "ssd_chunk_bwd": 0,
                "ssd_state": 0, "ssd_state_bwd": 0}, path

        train = _train_both(
            ["--arch", "gemma2-2b", "--steps", str(MESH1_TRAIN_STEPS),
             "--global-batch", "4", "--seq", "512", "--device", DEV,
             "--seed", str(seed)], mesh, kernels)

        ssm = {}
        for name, plens in MESH1_SSM.items():
            scfg = get_config(name)
            rng = np.random.default_rng(seed)
            sargs = launch_serve.build_parser().parse_args(
                ["--arch", name, "--device", DEV, "--seed", str(seed),
                 "--batch-size", str(len(plens)), "--new-tokens",
                 str(MESH1_SSM_NEW_TOKENS), "--max-len", "1024"])
            both = _serve_both(sargs, mesh, [
                rng.integers(1, scfg.vocab_size, n, dtype=np.int32)
                for n in plens], build_model(scfg), kernels)
            # one prefill: the SSD kernel once per Mamba2 layer, flash once
            # per shared-attention site, on local tensors on the mesh
            sites = num_shared_sites(scfg) if scfg.family == "hybrid" else 0
            for path in both["serve"]:
                assert both["serve"][path]["launches"] == {
                    "flash_attention": sites, "chunk_accum": 0,
                    "ssd_chunk": scfg.num_layers, "ssd_chunk_bwd": 0,
                    "ssd_state": scfg.num_layers, "ssd_state_bwd": 0}, \
                    (name, path)
            ssm[name] = dict(layers=scfg.num_layers, d_model=scfg.d_model,
                             ssm_chunk=scfg.ssm_chunk, prompts=list(plens),
                             new_tokens=MESH1_SSM_NEW_TOKENS,
                             ssd_launches_per_prefill=scfg.num_layers,
                             flash_launches_per_prefill=sites, **both)
        ssm_train = _train_both(MESH1_SSM_TRAIN + ["--device", DEV, "--seed",
                                                   str(seed)], mesh, kernels)
        # a step with remat: the SSD's forward kernels twice a Mamba2
        # layer (forward and recomputation), its backward kernels once, on
        # both paths
        layers = get_config(MESH1_SSM_TRAIN[1]).num_layers
        steps = int(MESH1_SSM_TRAIN[MESH1_SSM_TRAIN.index("--steps") + 1])
        for path in ("plain", "mesh"):
            got = ssm_train[path]["launches"]
            assert (got["ssd_chunk"], got["ssd_chunk_bwd"], got["ssd_state"],
                    got["ssd_state_bwd"]) == (
                2 * layers * steps, layers * steps, 2 * layers * steps,
                layers * steps), (path, got)
    finally:
        dist.destroy_process_group()
    res = dict(mesh={"data": 1, "model": 1},
               backend="nccl" if DEV == "cuda" else "gloo", arch=cfg.name,
               layers=cfg.num_layers, d_model=cfg.d_model, dtype="bfloat16",
               prompts=list(SERVE_PROMPTS), batch_size=args.batch_size,
               new_tokens=args.new_tokens, **served,
               flash_launches_per_prefill=served["serve"]["mesh"][
                   "launches"]["flash_attention"] // batches,
               train=dict(arch="gemma2-2b", steps=MESH1_TRAIN_STEPS,
                          global_batch=4, seq=512, **train),
               ssm=ssm,
               ssm_train=dict(argv=MESH1_SSM_TRAIN, **ssm_train),
               rank_bytes=_rank_bytes())
    emit("model_parallel_mesh1", **res)
    torch.cuda.empty_cache()
    return res


def _mp_rank(rank: int, world: int, port: int, job: str, argv: list,
             out: str) -> None:
    """One rank of a launcher's model-parallel run on card `rank`: its
    per-rank function, then its peak memory and numbers to out/."""
    import torch.distributed as dist

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    cpu = "cpu" in argv       # a CPU rehearsal (CARDS_ARGV)
    if not cpu:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=900))
    peak = (lambda: 0.0) if cpu else torch.cuda.max_memory_allocated
    try:
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if job == "serve":
            engine, done = launch_serve.serve(
                launch_serve.build_parser().parse_args(argv), rank, world)
            st = engine.stats
            res = dict(requests=len(done),
                       prefill_tok_per_s=st["prefill_tokens"]
                       / st["prefill_s"],
                       decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
                       new_tokens=[len(c.tokens) - c.prompt_len
                                   for c in done])
        else:
            with _SkipCheckpointWrites():
                records = launch_train.run(
                    launch_train.build_parser().parse_args(argv), rank,
                    world)
            res = dict(losses=[r["loss"] for r in records],
                       step_s=[r["seconds"] for r in records],
                       tokens_per_step=records[0]["tokens"])
        res.update(rank=rank, wall_s=time.perf_counter() - t0,
                   max_memory_allocated_gb=peak() / 1e9)
        with open(os.path.join(out, f"{job}{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_model_parallel_cards(seed: int) -> None:
    """With two or more cards: mixtral-8x7b served at its full 32 layers
    over every card (the params from model rank 0 by the tree broadcast,
    healthy and then over a failed link 0-1) and mamba2-780m over every
    card, and qwen3-8b and zamba2-1.2b trained with --model-parallel 2
    --data-parallel cards/2."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("model_parallel_cards", run=False, cards=cards)
        return
    import torch.multiprocessing as mp
    serve_argv = ["--arch", "mixtral-8x7b", "--model-parallel", str(cards),
                  "--seed", str(seed), "--requests", "4", "--batch-size",
                  "2", "--new-tokens", "16", "--prompt-len", "512",
                  "--max-len", "1024"]
    runs = [("serve", serve_argv)]
    if cards > 2:   # on a ring of two, link 0-1 is the whole axis
        runs.append(("serve", serve_argv + ["--inject-fault", "0-1"]))
    runs.append(("serve", ["--arch", "mamba2-780m", "--model-parallel",
                           str(cards), "--seed", str(seed), "--requests",
                           "4", "--batch-size", "2", "--new-tokens", "16",
                           "--prompt-len", "512", "--max-len", "1024"]))
    if cards % 2 == 0:
        for arch, steps in (("qwen3-8b", "3"), ("zamba2-1.2b", "2")):
            runs.append(("train", [
                "--arch", arch, "--model-parallel", "2", "--data-parallel",
                str(cards // 2), "--steps", steps, "--global-batch",
                str(cards), "--seq", "512", "--seed", str(seed),
                "--ckpt-dir", tempfile.mkdtemp(prefix="chip_smoke_cards_")]))
    runs = [(job, argv + CARDS_ARGV) for job, argv in runs]
    for job, argv in runs:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            mp.spawn(_mp_rank, args=(cards, _free_port(), job, argv, out),
                     nprocs=cards, join=True)
            ranks = []
            for r in range(cards):
                with open(os.path.join(out, f"{job}{r}.json")) as f:
                    ranks.append(json.load(f))
        if job == "serve":
            assert all(r["requests"] == 4 for r in ranks)
        else:
            shutil.rmtree(argv[argv.index("--ckpt-dir") + 1],
                          ignore_errors=True)
            assert all(math.isfinite(l) for l in ranks[0]["losses"])
        emit("model_parallel_cards", run=True, cards=cards, job=job,
             argv=argv, seconds=time.perf_counter() - t0, ranks=ranks)


# phase 35: the dry run on the card's machine, fake CUDA tensors
DRYRUN_CARDS = [("qwen3-8b", "train_4k", "off"),
                ("qwen3-8b", "prefill_32k", "off"),
                ("mixtral-8x7b", "decode_32k", "on"),
                ("gemma2-2b", "long_500k", "off"),       # a skip
                ("mamba2-780m", "prefill_32k", "off"),   # the SSD op's
                ("zamba2-1.2b", "train_4k", "on"),       # fake, 3 heads
                ("qwen3-8b", "decode_32k", "off")]       # cache on head_dim
# the dry run's CLI, then the launches this process made
_DRYRUN_CHILD = """
import json, sys
from repro_torch.kernels import (CHUNK_ACCUM_KERNEL, FLASH_KERNEL,
                                 SSD_KERNEL, SSD_STATE_KERNEL)
from repro_torch.launch import dryrun
rc = dryrun.main(sys.argv[1:])
print(json.dumps({"launches": {"flash_attention": FLASH_KERNEL.launches,
                               "chunk_accum": CHUNK_ACCUM_KERNEL.launches,
                               "ssd_chunk": SSD_KERNEL.launches,
                               "ssd_state": SSD_STATE_KERNEL.launches}}))
sys.exit(rc)
"""


def phase_dryrun_cards() -> dict:
    """`python -m repro_torch.launch.dryrun`'s main with fake CUDA tensors
    (the default --device cuda): one process per cell, all started
    together; each must print OK (or the reference's SKIP), exit 0 and
    launch no kernel."""
    from repro_torch.configs import shape_by_name, skip_reason
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = [((arch, shape, pod), subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD, "--arch", arch, "--shape",
         shape, "--multi-pod", pod, "--out", out], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for arch, shape, pod in DRYRUN_CARDS]
    cells, failed = [], []
    try:
        for (arch, shape, pod), proc in procs:
            so, se = proc.communicate(timeout=900)
            if proc.returncode:
                failed.append((arch, shape, so[-3000:], se[-3000:]))
                continue
            lines = [l for l in so.splitlines() if l.strip()]
            launches = json.loads(lines[-1])["launches"]
            assert not any(launches.values()), (arch, shape, launches)
            mesh = "2x16x16" if pod == "on" else "16x16"
            tag = f"{arch}/{shape}/{mesh}"
            skip = skip_reason(arch, shape_by_name(shape))
            assert lines[0].startswith(("SKIP " if skip else "OK   ") + tag), \
                lines[0]
            with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json")) as f:
                rec = json.load(f)
            cells.append(dict(line=lines[0], launches=launches,
                              seconds=rec["seconds"], skip=rec["skip"],
                              memory=rec["memory"], cost=rec["cost"],
                              collective_bytes=rec["collective_bytes"],
                              collective_ops=rec["collective_ops"],
                              roofline=rec["roofline"]))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    assert not failed, failed
    res = dict(cells=cells, device="cuda (fake tensors)",
               total_memory=torch.cuda.get_device_properties(0).total_memory,
               spec_hbm_bytes=H100_SXM.hbm_bytes,
               seconds=time.perf_counter() - t0)
    emit("dryrun_cards", **res)
    return res


# phase 36: the counter around real steps on the card
ROOFLINE_PREFILL = (2, 1024)        # phase 6's batch of its longest prompts
ROOFLINE_TIMED = 5                  # timed calls after one warm-up


def _measured_row(name: str, shape, counted: dict, model_flops: float,
                  times: list, prof: dict) -> dict:
    """The counted per-device work of one step beside its measured
    seconds: the RooflineTerms bound, and the model FLOPs' share of the
    card's bf16 peak over the wall and over the device-busy seconds."""
    from repro_torch.analysis.roofline import RooflineTerms
    terms = RooflineTerms(name, shape, "1", 1, counted["flops"],
                          counted["bytes"], counted["collective_bytes"],
                          model_flops)
    wall = float(np.median(times))
    return dict(arch=name, shape=shape, flops=counted["flops"],
                bytes=counted["bytes"], model_flops=model_flops,
                compute_s=terms.compute_s, memory_s=terms.memory_s,
                bound_s=terms.bound_s, dominant=terms.dominant,
                useful_flops_ratio=terms.useful_flops_ratio,
                wall_s=times, wall_s_median=wall, busy_s=prof["busy_s"],
                traced_wall_s=prof["wall_s"], launches=prof["launches"],
                idle_share=1 - prof["busy_s"] / wall,
                mfu=model_flops / (wall * PEAK_BF16_FLOPS),
                mfu_busy=model_flops / (prof["busy_s"] * PEAK_BF16_FLOPS),
                bound_share=terms.bound_s / wall,
                top_kernels=prof["top_kernels"])


def _traced_call(fn) -> dict:
    """One call of `fn` between synchronizes under the benchmark's device
    trace (bench/trace.py): its wall seconds, device busy seconds (the
    union of the card's busy intervals), device operations, and the top
    kernels as [name, ms]."""
    from bench.trace import DeviceTrace, Spans
    torch.cuda.synchronize()
    with DeviceTrace(Spans()) as trace:
        torch.cuda.synchronize()
        t0, t0_ns = time.perf_counter(), time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = trace.summary(wall, t0_ns)
    return {"wall_s": wall, "busy_s": s.busy_s, "launches": s.launches,
            "top_kernels": [[k[:80], v * 1e3] for k, v in s.top_ops(8)]}


def _timed_calls(fn, n: int) -> list:
    fn()                                            # warm-up
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_roofline_measured(seed: int) -> dict:
    """qwen3-8b's prefill at full width (flash 36 times a prefill) and
    gemma2-2b's train step (phase 9's: 4 x 512, bf16 compute, fp32
    masters, AdamW, remat): `analysis.hlo_count` counts one call on real
    tensors; the same call is timed (wall, between synchronizes) and
    traced (device busy); the bound is `analysis.roofline`'s against
    `H100_SXM`."""
    from repro_torch.analysis.hlo_count import Counter
    from repro_torch.analysis.roofline import model_flops_for
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import (CHUNK_ACCUM_KERNEL, FLASH_KERNEL,
                                     SSD_KERNEL, SSD_STATE_KERNEL)
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   host_batch_slice, init_train_state,
                                   make_train_step)
    kernels = {"flash_attention": FLASH_KERNEL,
               "chunk_accum": CHUNK_ACCUM_KERNEL, "ssd_chunk": SSD_KERNEL,
               "ssd_state": SSD_STATE_KERNEL}
    for k in kernels.values():
        k.launches = 0
    rows = []

    cfg = get_config("qwen3-8b")
    model = build_model(cfg)
    params = model.init(seed, torch.bfloat16, DEV)
    b, s = ROOFLINE_PREFILL
    toks = torch.tensor(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)), device=DEV)
    state = model.init_decode_state(b, 2 * s, torch.bfloat16, DEV)

    @torch.no_grad()
    def prefill():
        return model.prefill(params, {"tokens": toks}, state)[1]
    times = _timed_calls(prefill, ROOFLINE_TIMED)
    prof = _traced_call(prefill)
    flash = FLASH_KERNEL.launches
    with Counter() as c:
        logits = prefill()
    assert FLASH_KERNEL.launches - flash == cfg.num_layers
    assert logits.shape == (b, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    rows.append(_measured_row(
        cfg.name, f"prefill {b}x{s}", c.totals(), model_flops_for(
            cfg, ShapeSpec("prefill", "prefill", s, b)), times, prof))
    del params, state, logits
    torch.cuda.empty_cache()

    arch, steps_batch, seq = TRAIN_ARGV[1], 4, 512
    cfg = get_config(arch)
    model = build_model(cfg, remat=True)
    params, opt = init_train_state(model, seed, DEV)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                                           total_steps=10),
                     compute_dtype=torch.bfloat16)
    step = make_train_step(model, tc)
    batch = {k: v.to(DEV) for k, v in host_batch_slice(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                   global_batch=steps_batch), 0, 0, steps_batch).items()}
    losses = []

    def train():
        losses.append(float(step(params, opt, batch)[2]["loss"]))
    times = _timed_calls(train, 2)
    prof = _traced_call(train)
    with Counter() as c:
        train()
    assert all(math.isfinite(l) for l in losses), losses
    rows.append(_measured_row(
        cfg.name, f"train {steps_batch}x{seq}", c.totals(), model_flops_for(
            cfg, ShapeSpec("train", "train", seq, steps_batch)), times,
        prof))
    del params, opt
    torch.cuda.empty_cache()
    launches = {n: k.launches for n, k in kernels.items()}
    assert launches["chunk_accum"] == launches["ssd_chunk"] == \
        launches["ssd_state"] == 0
    res = dict(rows=rows, launches=launches, losses=losses,
               peak_flops_bf16=PEAK_BF16_FLOPS, hbm_bw=PEAK_BYTES)
    emit("roofline_measured", **res)
    return res


# phase 37: the port's examples at their documented flags
EXAMPLES = [["quickstart_torch.py"],
            ["schedule_explorer_torch.py"],
            ["serve_lm_torch.py", "--arch", "mixtral-8x7b"],
            ["train_lm_torch.py", "--arch", "qwen3-8b", "--steps", "200"]]


def phase_examples() -> dict:
    """examples/*_torch.py on the card (no --device: the default), each in
    its own process, all started together: each must exit 0.  quickstart
    and schedule_explorer run their programs on stacked ranks and print
    their chunk_accum launches; serve_lm prints its flash launches."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for cmd in EXAMPLES:
            extra = ["--ckpt-dir", os.path.join(tmp, "ckpt")] \
                if cmd[0] == "train_lm_torch.py" else []
            procs.append((cmd, time.perf_counter(), subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples", cmd[0]),
                 *cmd[1:], *extra], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        runs = []
        try:
            for cmd, start, p in procs:
                out, err = p.communicate(timeout=600)
                runs.append(dict(command=" ".join(["python", "examples/"
                                                   + cmd[0], *cmd[1:]]),
                                 rc=p.returncode, out=out, err=err,
                                 seconds=time.perf_counter() - start))
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    launches = {"chunk_accum": {}, "flash_attention": {}}
    for run in runs:
        assert run["rc"] == 0, (run["command"], run["err"][-3000:])
        name = run["command"].split("/")[1].split(".")[0]
        for kernel in launches:
            m = re.search(rf"^{kernel} launches: (\d+)$", run["out"], re.M)
            if m:
                launches[kernel][name] = int(m.group(1))
    assert "cuda" in runs[0]["out"] and "cuda" in runs[1]["out"]
    assert launches["chunk_accum"]["quickstart_torch"] > 0, launches
    assert runs[2]["out"].count("req ") == 6, runs[2]["out"]
    assert "finished at step 200;" in runs[3]["out"], runs[3]["out"]
    res = dict(commands=[r["command"] for r in runs],
               rcs=[r["rc"] for r in runs],
               seconds={r["command"]: r["seconds"] for r in runs},
               launches=launches, wall_s=time.perf_counter() - t0,
               tails={r["command"]: r["out"].splitlines()[-3:]
                      for r in runs})
    emit("examples", **res)
    return res


# phase 38: AdamW on the multi-tensor kernel against the loop
ADAMW_ODD = [(1,), (3,), (7,), (4097,), (2 ** 20 + 5,), (3, 7), (4097, 3),
             (5, 2 ** 12)]
ADAMW_STDS = (1.0, 1e-5, 1e-3)    # the three steps' gradient scales
ADAMW_NORM_RTOL = 2.0 ** -20      # the kernel's norm against float64


def _off(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t starting `offset` floats into a buffer of its
    own (offset 1: 4 bytes off 16)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _adamw_vs_loop(params: dict, seed: int, offset: int = 0) -> dict:
    """Three steps of the kernel on `params` (name -> float32 tensor on the
    card, updated in place) and of the loop on copies, the loop from the
    kernel's scale; moments and gradients `offset` floats into their
    buffers.  Per step: torch.equal counts, the norms against float64,
    launches, and whether the kernel's scale is the loop's clamp of its
    norm."""
    from repro_torch.kernels import adamw as K
    from repro_torch.train import AdamWConfig
    from repro_torch.train import optimizer as opt
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    loop_p = {n: p.clone() for n, p in params.items()}

    def moments():
        return {n: _off(torch.zeros_like(p), offset)
                for n, p in params.items()}
    mu_k, nu_k, mu_l, nu_l = moments(), moments(), moments(), moments()
    loop_state = opt.AdamWState(0, mu_l, nu_l)
    loop_named = list(loop_p.items())
    gen = torch.Generator(DEV).manual_seed(seed)
    steps = []
    for k, std in enumerate(ADAMW_STDS):
        grads = {n: _off(torch.randn(p.shape, device=DEV, generator=gen)
                         * std, offset) for n, p in params.items()}
        ref = math.sqrt(sum(float(g.double().square().sum())
                            for g in grads.values()))
        plain = float(opt.global_norm(grads))
        lr = opt.lr_schedule(cfg, k)
        b1c, b2c = opt._bias_corrections(cfg, k + 1)
        entries = [(n, p, grads[n], mu_k[n], nu_k[n])
                   for n, p in params.items()]
        before = K.NORM_KERNEL.launches + K.UPDATE_KERNEL.launches
        out, _ = K.step(entries, cfg.grad_clip, K.constants(
            cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay, lr, b1c, b2c))
        launches = K.NORM_KERNEL.launches + K.UPDATE_KERNEL.launches - before
        clamp = torch.clamp(cfg.grad_clip / (out[0] + 1e-9), max=1.0)
        scale_is_clamp = bool(torch.equal(clamp, out[1]))
        opt._loop(cfg, grads, loop_state, loop_named, out[1], lr, b1c, b2c)
        unequal = {key: [n for n in params if not torch.equal(a[n], b[n])]
                   for key, a, b in (("p", params, loop_p), ("mu", mu_k, mu_l),
                                     ("nu", nu_k, nu_l))}
        gnorm = float(out[0])
        steps.append(dict(
            std=std, gnorm=gnorm, float64=ref, global_norm=plain,
            rel_err=abs(gnorm - ref) / ref,
            global_norm_rel_err=abs(plain - ref) / ref,
            scale=float(out[1]), scale_is_clamp=scale_is_clamp,
            launches=launches,
            unequal={k: v[:5] for k, v in unequal.items()},
            unequal_counts={k: len(v) for k, v in unequal.items()}))
        del grads
    return dict(tensors=len(params), elements=sum(p.numel() for p in
                                                  params.values()),
                steps=steps)


def _adamw_time(params: dict, seed: int) -> dict:
    """Device ms of one step from a CUDA graph (eager in `*_eager_ms`), the
    kernel's (norm and update) and the loop's (global_norm, the clamp and
    the loop) on the same tensors, beside the bytes bound (the update's 28
    bytes a parameter, the norm's 4)."""
    from repro_torch.kernels import adamw as K
    from repro_torch.train import AdamWConfig
    from repro_torch.train import optimizer as opt
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    gen = torch.Generator(DEV).manual_seed(seed)
    grads = {n: torch.randn(p.shape, device=DEV, generator=gen)
             for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    entries = [(n, p, grads[n], mu[n], nu[n]) for n, p in params.items()]
    consts = K.constants(cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay, 1e-4,
                         0.1, 0.05)
    named = list(params.items())
    state = opt.AdamWState(0, mu, nu)

    def kernel():
        K.step(entries, cfg.grad_clip, consts)

    def loop():
        gnorm = opt.global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        opt._loop(cfg, grads, state, named, scale, 1e-4, 0.1, 0.05)
    n = sum(p.numel() for p in params.values())
    res = dict(elements=n, bound_ms=32 * n / PEAK_BYTES * 1e3,
               bound_by="bytes")
    for name, fn in (("kernel", kernel), ("loop", loop)):
        res[f"{name}_eager_ms"] = cuda_ms(fn, iters=5, warmup=2)
        res[f"{name}_ms"] = graph_ms(fn, calls=1, iters=5)
        torch.cuda.empty_cache()
    return res


def _adamw_through_update(params: dict, seed: int) -> dict:
    """Three steps through `adamw_update` on the masters: the kernel path's
    element count and launches a step, and the host ms of each call (no
    sync inside it)."""
    from repro_torch.kernels import adamw as K
    from repro_torch.train import AdamWConfig, adamw_update
    from repro_torch.train import optimizer as opt
    module = torch.nn.ParameterDict({n.replace(".", "/"): torch.nn.Parameter(
        p, requires_grad=False) for n, p in params.items()})
    state = opt.init_adamw(module)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    gen = torch.Generator(DEV).manual_seed(seed)
    host_ms, counted, launches = [], [], []
    for _ in range(3):
        grads = {n: torch.randn(p.shape, device=DEV, generator=gen)
                 for n, p in module.named_parameters()}
        torch.cuda.synchronize()
        k0, l0 = opt.UPDATED.kernel, (K.NORM_KERNEL.launches
                                      + K.UPDATE_KERNEL.launches)
        t0 = time.perf_counter()
        _, state, metrics = adamw_update(cfg, grads, state, module)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        counted.append(opt.UPDATED.kernel - k0)
        launches.append(K.NORM_KERNEL.launches + K.UPDATE_KERNEL.launches
                        - l0)
        assert metrics["grad_norm"].device.type == torch.device(DEV).type
        del grads
    return dict(host_ms=host_ms, elements=counted, launches=launches)


def _adamw_trained(seed: int) -> dict:
    """One train step's own gradients (mamba2-780m at full width, bf16
    compute, remat, 2 x 1024 tokens): the kernel's step on the masters
    launched right after `loss_and_grad`, with no sync, then the loop from
    the kernel's scale on copies of the masters taken before it: p, mu
    and nu torch.equal (a read of the gradients before the backward pass
    is done would show here)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as K
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   init_train_state, loss_and_grad)
    from repro_torch.train import optimizer as opt
    cfg = get_config("mamba2-780m")
    model = build_model(cfg, remat=True)
    params, state = init_train_state(model, seed, DEV)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=10,
                                           total_steps=1000),
                     compute_dtype=torch.bfloat16)
    o = tc.optimizer
    gen = torch.Generator(DEV).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 1024), device=DEV,
                         generator=gen)
    _, grads, _ = loss_and_grad(model, params, {"tokens": toks}, tc)
    named = [(n, p.detach()) for n, p in params.named_parameters()]
    masters = {n: p.clone() for n, p in named}
    lr = opt.lr_schedule(o, 0)
    b1c, b2c = opt._bias_corrections(o, 1)
    out, _ = K.step([(n, p, grads[n], state.mu[n], state.nu[n])
                     for n, p in named], o.grad_clip,
                    K.constants(o.b1, o.b2, o.eps, o.weight_decay, lr, b1c,
                                b2c))
    torch.cuda.synchronize()
    plain = float(opt.global_norm(grads))
    unequal = []
    for n, p in named:
        mu, nu, lp = (torch.zeros_like(p), torch.zeros_like(p),
                      masters.pop(n))
        opt._loop(o, {n: grads[n]}, opt.AdamWState(0, {n: mu}, {n: nu}),
                  [(n, lp)], out[1], lr, b1c, b2c)
        for key, a, b in (("p", p, lp), ("mu", state.mu[n], mu),
                          ("nu", state.nu[n], nu)):
            if not torch.equal(a, b):
                unequal.append([n, key, int((a != b).sum()),
                                float((a - b).abs().max())])
    del params, state, grads
    torch.cuda.empty_cache()
    return dict(tensors=len(named), gnorm=float(out[0]), global_norm=plain,
                scale=float(out[1]), unequal=unequal[:10],
                unequal_count=len(unequal))


def phase_adamw(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state
    adamw.NORM_KERNEL.launches = adamw.UPDATE_KERNEL.launches = 0
    gen = torch.Generator(DEV).manual_seed(seed)
    odd = {f"odd{i}": torch.randn(s, device=DEV, generator=gen)
           for i, s in enumerate(ADAMW_ODD)}
    res = dict(odd=_adamw_vs_loop(odd, seed),
               odd_off=_adamw_vs_loop({n: _off(p, 1) for n, p in
                                       odd.items()}, seed, offset=1),
               trained=_adamw_trained(seed))
    params, _ = init_train_state(build_model(get_config("mamba2-780m")),
                                 seed, DEV)
    masters = {n: p.detach() for n, p in params.named_parameters()}
    del params
    res["mamba2"] = _adamw_vs_loop(masters, seed)
    torch.cuda.empty_cache()
    res["update"] = _adamw_through_update(masters, seed)
    res["time"] = _adamw_time(masters, seed)
    del masters
    torch.cuda.empty_cache()
    res.update(adamw_norm=adamw.NORM_KERNEL.launches,
               adamw_update=adamw.UPDATE_KERNEL.launches)
    emit("adamw", **res)
    assert not res["trained"]["unequal_count"], res["trained"]
    for case in ("odd", "odd_off", "mamba2"):
        for st in res[case]["steps"]:
            assert not any(st["unequal_counts"].values()), (case, st)
            assert st["rel_err"] <= ADAMW_NORM_RTOL, (case, st)
            assert abs(st["gnorm"] - st["float64"]) <= \
                abs(st["global_norm"] - st["float64"]), (case, st)
            assert st["launches"] <= 3 and st["scale_is_clamp"], (case, st)
    n = res["mamba2"]["elements"]
    assert res["update"]["elements"] == [n] * 3, res["update"]
    assert all(k <= 3 for k in res["update"]["launches"]), res["update"]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_device()
    phase_build()
    kern = phase_kernel_vs_plain(args.seed)
    accum = phase_chunk_accum_vs_plain(args.seed)
    phase_model_vs_cpu(args.seed)
    from repro_torch.kernels import CHUNK_ACCUM_KERNEL
    CHUNK_ACCUM_KERNEL.launches = 0   # phase_serve zeroes the flash count
    serve = phase_serve(args.seed)
    assert CHUNK_ACCUM_KERNEL.launches == 0     # serving runs no collective
    phase_entry_point()
    torch.cuda.empty_cache()          # the serve model is gone
    coll = phase_collectives_stacked(args.seed)
    phase_train(args.seed)
    phase_train_vs_cpu(args.seed)
    phase_train_entry_point()
    phase_nccl_p2p(args.seed)
    ssd = phase_ssd_vs_plain(args.seed)
    phase_ssm_model_vs_cpu(args.seed)
    ssm_serve = phase_serve_ssm(args.seed)
    phase_ssm_entry_point()
    long = phase_train_long(args.seed)
    phase_train_long_vs_cpu(args.seed)
    phase_supervisor_restore(args.seed)
    cache = phase_schedule_cache(args.seed)
    repair = phase_repair_stacked(args.seed)
    phase_model_vs_cpu(args.seed, ("qwen2-moe-a2.7b", "mixtral-8x7b"),
                       "moe_model_vs_cpu")
    moe_serve = phase_serve_moe(args.seed)
    phase_moe_entry_point()
    phase_alltoall_stacked(args.seed)
    rooted = phase_rooted_stacked(args.seed)
    phase_families_vs_cpu(args.seed)
    vlm = phase_serve_family(args.seed, "paligemma-3b", VLM_PROMPTS,
                             "serve_vlm")
    audio = phase_serve_family(args.seed, "whisper-medium", AUDIO_PROMPTS,
                               "serve_audio")
    fam_train = phase_train_families(args.seed)
    phase_train_families_vs_cpu(args.seed)
    phase_families_entry_point()
    mesh1 = phase_model_parallel_mesh1(args.seed)
    phase_model_parallel_cards(args.seed)
    dry = phase_dryrun_cards()
    measured = phase_roofline_measured(args.seed)
    examples = phase_examples()
    adamw = phase_adamw(args.seed)
    # the later slices' paths, each counted from 0 just before it
    paths = {name: {"train_long": n} for name, n in
             long["kernel_launches"].items()}
    paths["chunk_accum"].update(schedule_cache=cache["launches"],
                                repair_stacked=repair["launches"],
                                rooted_stacked=rooted["launches"])
    paths["flash_attention"].update(serve_moe=moe_serve["flash_launches"],
                                    serve_vlm=vlm["flash_launches"],
                                    serve_audio=audio["flash_launches"])
    for name, n in fam_train["launches"].items():
        paths.setdefault(name, {})["train_families"] = n
    for name in ("flash_attention", "chunk_accum", "ssd_chunk", "ssd_state"):
        paths.setdefault(name, {})
        paths[name]["model_parallel_mesh1"] = \
            mesh1["serve"]["mesh"]["launches"][name]
        paths[name]["model_parallel_mesh1_train"] = \
            mesh1["train"]["mesh"]["launches"][name]
        for arch, cell in mesh1["ssm"].items():
            paths[name][f"model_parallel_mesh1_{arch}"] = \
                cell["serve"]["mesh"]["launches"][name]
        paths[name]["model_parallel_mesh1_ssm_train"] = \
            mesh1["ssm_train"]["mesh"]["launches"][name]
        paths[name]["dryrun_cards"] = sum(c["launches"][name]
                                          for c in dry["cells"])
        paths[name]["roofline_measured"] = measured["launches"][name]
    for cell in ("train", "ssm_train"):
        for name in ("ssd_chunk_bwd", "ssd_state_bwd"):
            paths[name][f"model_parallel_mesh1_{cell}"] = \
                mesh1[cell]["mesh"]["launches"][name]
    for name, by_example in examples["launches"].items():
        for example, n in by_example.items():
            paths[name][f"examples_{example}"] = n
    for name in ("adamw_norm", "adamw_update"):
        for cell in ("train", "ssm_train"):
            for path in ("plain_kernel", "plain", "mesh"):
                paths[name][f"model_parallel_mesh1_{cell}_{path}"] = \
                    mesh1[cell][path]["launches"][name]
        paths[name]["adamw"] = adamw[name]

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": serve["flash_launches"],
        "launches_by_path": paths["flash_attention"],
        "max_abs_err": kern["main_max_abs_err"],
        "held_against_plain": True,
        "ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}, {
        "name": "chunk_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunk_accum.cu",
        "replaces": "src/repro/kernels/chunk_accum.py:23",
        "launches": coll["launches"],
        "launches_by_path": paths["chunk_accum"],
        "max_abs_err": accum["max_abs_err"],
        "held_against_plain": True,
        "ms": accum["kernel_ms"], "plain_ms": accum["plain_ms"],
        "bound_ms": accum["bound_ms"], "bound_by": accum["bound_by"],
        "library_ms": accum["library_ms"]}, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:32",
        "launches": ssm_serve["ssd_launches"],
        "launches_by_path": paths["ssd_chunk"],
        "max_abs_err": ssd["main_max_abs_err"],
        "held_against_plain": True,
        "ms": ssd["kernel_ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": ssd["library_ms"]}, {
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": None,
        "launches": fam_train["launches"]["ssd_chunk_bwd"],
        "launches_by_path": paths["ssd_chunk_bwd"],
        "max_grad_errs": ssd["backward_train"]["grad_errs"],
        "held_against_plain": True,
        "ms": ssd["backward_train"]["kernel_ms"],
        "plain_ms": ssd["backward_train"]["plain_autograd_ms"],
        "bound_ms": ssd["backward_train"]["bound_ms"],
        "bound_by": ssd["backward_train"]["bound_by"],
        "library_ms": None}] + [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_state.cu",
        "replaces": None,
        "launches": fam_train["launches"][name],
        "launches_by_path": paths[name],
        "max_grad_errs": ssd["chunked"]["worst"]["bfloat16"],
        "max_out_errs": {
            "prefill": {k: ssd["chunked"]["worst"]["bfloat16"][k]
                        for k in ("y", "final")},
            "train": ssd["backward_train"]["out_errs"],
            "train_zamba2": ssd["backward_zamba2"]["out_errs"]},
        "held_against_plain": True,
        "ms": ssd["state_train"][part]["kernel_ms"],
        "plain_ms": ssd["state_train"][part].get(
            "plain_ms", ssd["state_train"][part].get("plain_autograd_ms")),
        "bound_ms": ssd["state_train"][part]["bound_ms"],
        "bound_by": ssd["state_train"][part]["bound_by"],
        "library_ms": None} for name, part in (
            ("ssd_state", "forward"), ("ssd_state_bwd", "backward"))] + [{
        "name": "adamw", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": None,
        "launches": {part: fam_train["launches"][f"adamw_{part}"]
                     for part in ("norm", "update")},
        "launches_by_path": {part: paths[f"adamw_{part}"]
                             for part in ("norm", "update")},
        "bit_equal_to_loop": True,
        "norm_rel_err": max(st["rel_err"] for st in
                            adamw["mamba2"]["steps"]),
        "held_against_plain": True,
        "ms": adamw["time"]["kernel_ms"],
        "plain_ms": adamw["time"]["loop_ms"],
        "bound_ms": adamw["time"]["bound_ms"],
        "bound_by": adamw["time"]["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
