#!/usr/bin/env python3
"""Drives the PyTorch port (src/repro_torch) on one CUDA card and checks it.

    python3 chip_smoke.py [--seed N]

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. device           CUDA required; TF32 off; the card's name and power limit.
2. build            nvcc builds every kernel from src/repro_torch/kernels/csrc.
3. kernel_vs_plain  each kernel against its plain PyTorch version on the card
                    over dtypes, head dims, head groupings, masks and ragged
                    lengths; times at the serving shape beside the bound, the
                    plain version and one PyTorch library call.
4. model_vs_cpu     reduced qwen3-8b and gemma2-2b, the same weights on the
                    card (kernel path) and on the CPU (plain path): prefill and
                    decode logits agree.
5. serve            the main path: qwen3-8b at full width (36 layers,
                    d_model 4096, bf16, random weights from --seed) serves 4
                    long, ragged prompts through ServingEngine; the flash
                    kernel is launched once per layer per batch.
6. entry_point      `python -m repro_torch.launch.serve --arch qwen3-8b
                    --reduced` with no --device flag exits 0.

Then the card's line from nvidia-smi, a `kernels` JSON line, and as the last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {torch.float32: 1e-4,   # accumulation order
       torch.bfloat16: 2e-2}  # the output's rounding
MODEL_ATOL = 1e-4             # fp32 logits, kernel vs plain attention
MAIN = dict(b=2, h=32, hkv=8, s=1024, d=128)   # qwen3-8b prefill attention


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


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, log = build.build("flash_attention", force=True)
    spills = [l.strip() for l in log.splitlines() if "spill" in l
              and not l.strip().startswith("0 bytes stack frame, 0 bytes")]
    emit("build", kernel="flash_attention",
         source="src/repro_torch/kernels/csrc/flash_attention.cu",
         library=os.path.relpath(path, ROOT),
         seconds=time.perf_counter() - t0, nonzero_spill_lines=spills)


def _qkv(gen, b, h, hkv, sq, skv, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(b, h, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)


def phase_kernel_vs_plain(seed: int) -> dict:
    from repro_torch.kernels import flash_attention, mha_reference
    gen = torch.Generator(device="cuda").manual_seed(seed)
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
    m = MAIN
    main_cases = [((m["b"], m["h"], m["hkv"], s, s, m["d"]), dtype)
                  for s in (1024, 1000)
                  for dtype in (torch.bfloat16, torch.float32)]
    cases = [(shape, dtype, mask) for shape in shapes
             for dtype in (torch.float32, torch.bfloat16) for mask in masks]
    cases += [(shape, dtype, dict(causal=True)) for shape, dtype in main_cases]
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

    # times at the serving shape: prefill attention of qwen3-8b, S = 1024
    q, k, v = _qkv(gen, m["b"], m["h"], m["hkv"], m["s"], m["s"], m["d"],
                   torch.bfloat16)
    plain_ms = cuda_ms(lambda: mha_reference(q, k, v, causal=True))
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    kernel_ms = (kernel_ms + cuda_ms(
        lambda: flash_attention(q, k, v, causal=True))) / 2
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
               plain_ms=plain_ms, library_ms=library_ms,
               library="torch.nn.functional.scaled_dot_product_attention",
               bound_ms=bound[bound_by], bound_by=bound_by, flops=flops,
               bytes=nbytes,
               fp32_core_bound_ms=flops / PEAK_F32_FLOPS * 1e3)
    emit("kernel_vs_plain", **res)
    return res


def phase_model_vs_cpu(seed: int) -> None:
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import FLASH_KERNEL
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    for name in ("qwen3-8b", "gemma2-2b"):
        cfg = reduced_config(name)
        model = build_model(cfg)
        cpu = model.init(seed, torch.float32, "cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(seed)
        b, s, max_len = 2, 77, 96
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int64))
        before = FLASH_KERNEL.launches
        worst = 0.0
        with torch.inference_mode():
            cc, lc = tf.lm_prefill(cpu, cfg, tokens,
                                   tf.init_kv_caches(cfg, b, max_len))
            cg, lg = tf.lm_prefill(gpu, cfg, tokens.cuda(),
                                   tf.init_kv_caches(cfg, b, max_len,
                                                     device="cuda"))
            launched = FLASH_KERNEL.launches - before
            for index in range(s, s + 4):
                worst = max(worst, (lg.cpu() - lc).abs().max().item())
                tok = lc[:, -1].argmax(-1)[:, None]
                lc, cc = tf.lm_decode_step(cpu, cfg, tok, cc, index)
                lg, cg = tf.lm_decode_step(gpu, cfg, tok.cuda(), cg, index)
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
        assert torch.isfinite(lg).all()
        assert launched == cfg.num_layers, (name, launched)
        assert worst <= MODEL_ATOL, (name, worst)
        emit("model_vs_cpu", arch=name, reduced=True, prompt=[b, s],
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
    phase_model_vs_cpu(args.seed)
    serve = phase_serve(args.seed)
    phase_entry_point()

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": serve["flash_launches"],
        "max_abs_err": kern["main_max_abs_err"],
        "held_against_plain": True,
        "ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
