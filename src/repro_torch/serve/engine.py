"""Batched serving engine: request queue -> padded batch -> prefill ->
decode loop.  Counterpart of src/repro/serve/engine.py, same semantics.

Static batching with greedy sampling: requests are grouped into batches of
`batch_size`, prompts are left-padded with token 0 (the pad is not masked) to
a common length, prefill fills the decode state (KV caches, SSM states or
both, by family), then one decode step per generated token.  A sequence
stops at EOS or at its budget.  For the ssm and hybrid families the padded
length decides the path: a multiple of `cfg.ssm_chunk` takes the chunked
scan (the SSD kernel on the card), any other the sequential recurrence.
Requests of the vlm and audio families carry their frontend embeddings in
`extras` (`patch_embed` [P, d], `audio_embed` [T_enc, d]), stacked into the
prefill's feed in the weights' dtype; a vlm batch's patches come before its padded prompts, so
its caches and decode positions count them (pad and all, the pad sits
between the patches and the text, as in the reference).

With DTensor params (tensor parallelism, repro_torch.launch.sharding) the
decode state is placed by `decode_state_specs` on the params' mesh, and the
greedy argmax reads the whole logits (`full_tensor`), so ties go to the
lower token as on one card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.model_zoo import Model


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, 1] argmax of the last position's logits."""
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 32
    extras: Optional[Dict[str, np.ndarray]] = None   # patch/audio embeds


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray
    prompt_len: int
    latency_s: float


class ServingEngine:
    """Runs on the device of `params` (its `embed`).  The KV caches and conv
    states are in `dtype` (fp32 by default, also when the params are bf16;
    SSM states are always fp32).  `stats` sums, over all batches,
    the seconds spent in prefill and in decode (each ends when the sampled
    tokens reach the host) and the token positions each processed (a vlm
    prefill's patch rows included)."""

    def __init__(self, model: Model, params: nn.Module, *,
                 batch_size: int = 4, max_len: int = 512, eos_id: int = -1,
                 dtype=torch.float32):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.dtype = dtype
        self.device = params.embed.device
        self.queue: List[Request] = []
        self.stats = dict(prefill_s=0.0, decode_s=0.0, prefill_tokens=0,
                          decode_tokens=0)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ------------------------------------------------------------------ #
    def run(self) -> List[Completion]:
        done: List[Completion] = []
        while self.queue:
            batch = self.queue[:self.batch_size]
            self.queue = self.queue[self.batch_size:]
            done.extend(self._run_batch(batch))
        return done

    def _run_batch(self, reqs: Sequence[Request]) -> List[Completion]:
        # DTensor params run under no_grad: under inference mode DTensor
        # sees composite ops (a linear of a sharded input) whose sharding
        # it recomputes on every call
        sharded = isinstance(self.params.embed, DTensor)
        with torch.no_grad() if sharded else torch.inference_mode():
            return self._run_batch_inner(reqs)

    def _run_batch_inner(self, reqs: Sequence[Request]) -> List[Completion]:
        t0 = time.perf_counter()
        bsz = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        budget = max(r.max_new_tokens for r in reqs)
        # left-pad so the last prompt token is aligned at plen-1
        toks = np.zeros((bsz, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt

        cfg = self.model.cfg
        prefix = cfg.num_image_tokens if cfg.family == "vlm" else 0
        state = self.model.init_decode_state(
            bsz, min(self.max_len, plen + prefix + budget + 1), self.dtype,
            self.device)
        if isinstance(self.params.embed, DTensor):
            from repro_torch.launch.mesh import mesh_axis_sizes
            from repro_torch.launch.sharding import (decode_state_specs,
                                                     distribute_tree)
            mesh = self.params.embed.device_mesh
            state = distribute_tree(state, mesh, decode_state_specs(
                state, cfg, mesh_axis_sizes(mesh)))
        feed = {"tokens": torch.from_numpy(toks).to(self.device)}
        if reqs[0].extras:
            dtype = self.params.embed.dtype
            for k in reqs[0].extras:
                feed[k] = torch.from_numpy(np.stack(
                    [r.extras[k] for r in reqs])).to(self.device, dtype)
        state, logits = self.model.prefill(self.params, feed, state)
        tok = _greedy(logits)
        host_tok = tok.cpu().numpy()
        t1 = time.perf_counter()
        self.stats["prefill_s"] += t1 - t0
        self.stats["prefill_tokens"] += bsz * (plen + prefix)

        out = [list(r.prompt) for r in reqs]
        alive = np.ones(bsz, bool)
        for step in range(budget):
            for i in range(bsz):
                if alive[i]:
                    t = int(host_tok[i, 0])
                    out[i].append(t)
                    if t == self.eos_id or \
                            len(out[i]) - len(reqs[i].prompt) >= \
                            reqs[i].max_new_tokens:
                        alive[i] = False
            if not alive.any() or step == budget - 1:
                break
            logits, state = self.model.decode_step(
                self.params, tok, state, plen + prefix + step)
            tok = _greedy(logits)
            host_tok = tok.cpu().numpy()
            self.stats["decode_tokens"] += bsz

        dt = time.perf_counter() - t0
        self.stats["decode_s"] += time.perf_counter() - t1
        return [Completion(uid=r.uid, tokens=np.asarray(out[i], np.int32),
                           prompt_len=len(r.prompt), latency_s=dt)
                for i, r in enumerate(reqs)]
