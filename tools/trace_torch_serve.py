#!/usr/bin/env python3
"""Trace one batch of the PyTorch port's serving path on the card.

    python3 tools/trace_torch_serve.py [--arch mamba2-780m]
    python3 tools/trace_torch_serve.py --arch qwen2-moe-a2.7b
    python3 tools/trace_torch_serve.py --arch paligemma-3b
    python3 tools/trace_torch_serve.py --arch whisper-medium

One model at full width (qwen3-8b unless --arch names another the port
serves; bf16, random weights from seed 0), one batch of 2 prompts of 1000
tokens (for the ssm and hybrid families, 1000 rounded up to a multiple of
the config's ssm_chunk, so prefill takes the SSD kernel: 1024 for
mamba2-780m and zamba2-1.2b; for the vlm family 256 patch embeddings and
512 text tokens, for the audio family 1500 frames and 200 decoder tokens,
the stub frontends' outputs as the serve launcher draws them) and 16 new
tokens: the first batch of the serve phase of chip_smoke.py for qwen3-8b.  Runs the calls ServingEngine
makes for it (prefill, then greedy decode steps) once to warm up, times
REPEAT untraced prefills on the host clock (each ending in the sampled
token's copy to the host), then runs prefill and decode again under
torch.profiler.  Prints one JSON line per phase: host seconds (inflated by
the profiler's own cost), device busy seconds (the sum of kernel and copy
times, which do not overlap on one stream), the idle share, kernel launches,
host-to-device copies and syncs per step, the device time, launches and
share of the busy time of each hand-written kernel (flash attention; the
SSD intra-chunk kernel with its cum pre-pass), for a config with experts
the device time and share of its MoE blocks (`moe_block_*`: routing,
dispatch, experts, combine, shared expert) and of the three expert
products within them (`expert_products_*`), for the audio family the
device time and share of the encoder (`encoder_*`), and the kernels that
take the most device time.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

SEED, BATCH, PLEN, NEW_TOKENS, REPEAT = 0, 2, 1000, 16, 10
# text prompt lengths of the families with a frontend: serve_vlm's and
# serve_audio's longest prompts in chip_smoke.py
FAMILY_PLEN = {"vlm": 512, "audio": 200}
# the port's kernels, by a fragment of their device functions' names; the
# SSD kernel's cum pre-pass (ssd_chunk_cum) counts in its time, not in its
# launches
KERNELS = {"flash": "flash_fwd", "ssd": "ssd_chunk"}
PRE_PASS = "ssd_chunk_cum"
# host ranges around the MoE code, whose device time is the time of the
# kernels launched inside them
RANGES = {"moe_block": "moe_forward", "expert_products": "moe_expert_ffn",
          "encoder": "encdec_encode"}


def _ranged(fn, name):
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


def _annotate(cfg) -> None:
    """Wrap the MoE block and its expert products, or the encoder, in
    profiler ranges."""
    from repro_torch.models import encdec, moe, transformer
    if cfg.num_experts:
        transformer.moe_forward = _ranged(transformer.moe_forward,
                                          RANGES["moe_block"])
        moe._expert_ffn = _ranged(moe._expert_ffn, RANGES["expert_products"])
    if cfg.family == "audio":
        encdec.encode = _ranged(encdec.encode, RANGES["encoder"])


def _summary(prof, wall_s: float, steps: int) -> dict:
    events = prof.key_averages()
    # kernels and copies; a range's span on the device timeline (a user
    # annotation) is not device work
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation),
                       key=lambda e: e.self_device_time_total, reverse=True)
    busy_s = sum(e.self_device_time_total for e in on_device) / 1e6
    mine = {}
    for name, frag in KERNELS.items():
        found = [e for e in on_device if frag in e.key]
        secs = sum(e.self_device_time_total for e in found) / 1e6
        mine.update({
            f"{name}_s": secs,
            f"{name}_launches": sum(e.count for e in found
                                    if PRE_PASS not in e.key),
            f"{name}_share_of_busy": secs / busy_s if busy_s else 0.0})
    for name, key in RANGES.items():
        found = [e for e in events
                 if e.key == key and e.device_type == DeviceType.CPU]
        if found:
            secs = sum(e.device_time_total for e in found) / 1e6
            mine.update({f"{name}_s": secs,
                         f"{name}_calls": sum(e.count for e in found),
                         f"{name}_share_of_busy": secs / busy_s
                         if busy_s else 0.0})
    host = {e.key: e.count for e in events}
    return dict(
        steps=steps, wall_s=wall_s, device_busy_s=busy_s,
        idle_share=1 - busy_s / wall_s, **mine,
        kernel_launches_per_step=host.get("cudaLaunchKernel", 0) / steps,
        memcpy_per_step=host.get("cudaMemcpyAsync", 0) / steps,
        syncs_per_step=host.get("cudaStreamSynchronize", 0) / steps,
        top_kernels=[[e.key[:80], e.self_device_time_total / 1e3, e.count]
                     for e in on_device[:8]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_torch_serve: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import frontend_stub
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    _annotate(cfg)
    model = build_model(cfg)
    params = model.init(SEED, torch.bfloat16)
    plen = FAMILY_PLEN.get(cfg.family, PLEN)
    if cfg.family in ("ssm", "hybrid"):
        plen = -(-PLEN // cfg.ssm_chunk) * cfg.ssm_chunk
    rng = np.random.default_rng(SEED)
    feed = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (BATCH, plen))).cuda()}
    stubs = [frontend_stub(cfg, SEED, uid) for uid in range(BATCH)]
    if stubs[0] is not None:
        feed.update({k: torch.from_numpy(np.stack([x[k] for x in stubs]))
                     .to("cuda", torch.bfloat16) for k in stubs[0]})
    # a vlm sequence starts with its patches
    prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
    steps = NEW_TOKENS - 1
    clen = prefix + plen + NEW_TOKENS + 1

    def prefill():
        state = model.init_decode_state(BATCH, clen)
        state, logits = model.prefill(params, feed, state)
        tok = logits[:, -1].argmax(-1)[:, None]
        tok.cpu()
        return state, tok

    def decode(state, tok):
        for i in range(steps):
            logits, state = model.decode_step(params, tok, state,
                                              prefix + plen + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            tok.cpu()

    print(json.dumps({"phase": "device",
                      "name": torch.cuda.get_device_name(0),
                      "arch": cfg.name, "batch": BATCH,
                      "plen": plen, "frontend": {k: list(v.shape)
                                                 for k, v in feed.items()
                                                 if k != "tokens"},
                      "new_tokens": NEW_TOKENS}))
    with torch.inference_mode():
        decode(*prefill())                         # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(REPEAT):
            t0 = time.perf_counter()
            prefill()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        print(json.dumps({"phase": "prefill_untraced", "wall_s": walls,
                          "median_s": med,
                          "positions_per_s": BATCH * (prefix + plen) / med}))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, tok = prefill()
            wall = time.perf_counter() - t0
        print(json.dumps({"phase": "prefill", **_summary(prof, wall, 1)}))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode(state, tok)
            wall = time.perf_counter() - t0
        print(json.dumps({"phase": "decode", **_summary(prof, wall, steps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
