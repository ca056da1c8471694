"""Batched serving over the PyTorch port: the serving engine on a reduced
arch with random weights, serving a stream of requests (greedy decoding,
ring-buffer KV cache for sliding-window archs).  The counterpart of
examples/serve_lm.py, through `repro_torch.serve`; on the card each
prompt's attention runs in the hand-written flash kernel.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mixtral-8x7b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import KERNEL as FLASH
from repro_torch.models import build_model
from repro_torch.serve import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda: the card)")
    args = ap.parse_args()

    cfg = reduced_config(args.arch)
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    engine = ServingEngine(model, params, batch_size=4, max_len=256)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 20))
        engine.submit(Request(
            uid=i, prompt=rng.integers(1, cfg.vocab_size, plen,
                                       dtype=np.int32),
            max_new_tokens=args.new_tokens))
    for c in engine.run():
        gen = c.tokens[c.prompt_len:]
        print(f"req {c.uid}: prompt {c.prompt_len} tokens -> "
              f"generated {len(gen)}: {gen[:10]}... "
              f"({c.latency_s * 1e3:.0f} ms batch latency)")
    print(f"flash_attention launches: {FLASH.launches}")


if __name__ == "__main__":
    main()
