"""End-to-end training over the PyTorch port: train a reduced assigned
architecture with the port's stack — synthetic data pipeline, AdamW,
checkpointing, fault-tolerant supervisor.  The counterpart of
examples/train_lm.py, through `repro_torch.train`.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-8b \
        --steps 200 --ckpt-dir "$(mktemp -d)"
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 4
"""
import argparse
import os

from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device
from repro_torch.train import (AdamWConfig, TrainConfig, TrainSupervisor,
                               init_train_state, make_train_step)
from repro_torch.train.data import DataConfig, host_batch_slice


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = reduced_config(args.arch)
    model = build_model(cfg, remat=True)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=20,
                                           total_steps=args.steps))
    step = make_train_step(model, tc)
    params, opt = init_train_state(model, 0, device=device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch,
                    num_image_tokens=cfg.num_image_tokens,
                    encoder_seq=cfg.encoder_seq if cfg.is_encoder_decoder
                    else 0,
                    d_model=cfg.d_model)

    def step_fn(i, state):
        p, o = state
        batch = {k: v.to(device) for k, v in
                 host_batch_slice(dc, i, 0, args.batch).items()}
        p, o, metrics = step(p, o, batch)
        return (p, o), metrics

    os.makedirs(args.ckpt_dir, exist_ok=True)
    sup = TrainSupervisor(ckpt_dir=args.ckpt_dir, ckpt_every=50)
    state, final = sup.run(state=(params, opt), num_steps=args.steps,
                           step_fn=step_fn, log_every=20)
    print(f"finished at step {final}; "
          f"stragglers flagged: {len(sup.monitor.flagged)}")


if __name__ == "__main__":
    main()
