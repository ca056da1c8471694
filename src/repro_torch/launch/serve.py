"""Serving entry point on one card: random weights from --seed + batched engine.
Counterpart of src/repro/launch/serve.py for --model-parallel 1.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --prompt-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --device cpu

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

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.common import resolve_device
    from repro_torch.serve import Request, ServingEngine

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed,
                        torch.float32 if args.reduced else torch.bfloat16,
                        device)
    prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
    engine = ServingEngine(model, params, batch_size=args.batch_size,
                           max_len=args.max_len + prefix)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = args.prompt_len or int(rng.integers(4, 24))
        engine.submit(Request(
            uid=i,
            prompt=rng.integers(1, cfg.vocab_size, plen, dtype=np.int32),
            max_new_tokens=args.new_tokens,
            extras=frontend_stub(cfg, args.seed, i)))
    for c in engine.run():
        print(f"req {c.uid}: {c.prompt_len} prompt -> "
              f"{len(c.tokens) - c.prompt_len} new tokens "
              f"({c.latency_s * 1e3:.0f} ms batch)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
