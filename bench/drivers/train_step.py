"""Driver of the train-step cells: one data-parallel rank's training step
on one card, through the port's own entry (`make_train_step` on
`init_train_state`), with no gradient hook (one rank: no collective).

The traffic mix gives the global batch and sequence length, the compute
dtype, per-layer recomputation, the optimizer's settings, how many steps
the check follows (`checked_steps`) and the limits.

Inputs: the weights from the seed (`reference.make_weights`: one draw on
the card), copied into the program's float32 masters; step k's tokens
[batch, seq] drawn on the card from (seed, "tokens", k), so every row of
every step differs.

Set-up builds the step once and drives it through the checked steps
(also the warm-up), recording each step's loss, each parameter's first
gradient norm as the optimizer got it (worked out from AdamW's first
moment after step 1 and that step's clipping scale) and each parameter's
change after the last checked step.  The same step object then runs the
window.  With --trace 1 every step runs as its two halves,
`loss_and_grad` then `adamw_update`, the second timed alone between
synchronizations, in set-up and window alike.

Check, once the window has closed and the program's state is freed: the
plain float32 reference (`reference.<config's reference>.train`) follows
the checked steps from the same weights and tokens, reading the weights
rounded to the compute dtype as the step does.  Parameters whose
reference gradient norm is under a thousandth of the median parameter's
move under AdamW by rounding alone and are left out.  `grad_norm_gap`:
over the parameters, the median of |first gradient norm - reference| /
reference.  One number a parameter of `check_leaves` (name -> parameter,
"layers.-1." the last layer): |first gradient - reference| / |reference|
at elements drawn from the seed; the final norm's is the first gradient
the backward pass computes, the last mixer's out_proj's the first through
a mixer.  `change_norm_gap`: over the parameters, the largest |change
norm - reference| over the larger of the reference's change norm of that
parameter and of the median parameter.  Why these and not the largest
gaps of norms or the losses: PERF.md.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import time
from typing import Any, Dict

import torch

from bench.harness import RunContext, RunResult, load_reference
from bench.seeds import generator, sample_index
from bench.trace import DeviceTrace, Spans

from .common import peak_bytes, reset_peak, sync

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NEGLIGIBLE = 1e-3       # of the median parameter's reference gradient norm


def model_config(cfg: Dict[str, Any]):
    """The port's ModelConfig of a configuration file's keys."""
    from repro_torch.models.common import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def tokens(ctx: RunContext, step: int, device) -> torch.Tensor:
    tr = ctx.cell.traffic
    return torch.randint(0, ctx.cell.config["vocab_size"],
                         (tr["global_batch"], tr["seq_len"]), device=device,
                         generator=generator(device, ctx.seed, "tokens", step))


def run(ctx: RunContext) -> RunResult:
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_update,
                                   init_train_state, loss_and_grad,
                                   make_train_step)
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    device = torch.device(ctx.device)
    ref = load_reference(cfg["reference"])
    model = build_model(model_config(cfg), remat=tr["remat"])
    params, opt = init_train_state(model, ctx.seed, device)
    start = ref.make_weights(cfg, ctx.seed, device)
    names = [n for n, _ in params.named_parameters()]
    if names != list(start):
        raise ValueError("the reference's parameters are not the program's")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(start[n])
    adamw = AdamWConfig(**tr["optimizer"])
    tc = TrainConfig(optimizer=adamw,
                     compute_dtype=DTYPES[tr["compute_dtype"]])
    spans, adamw_s = Spans(), []

    if ctx.trace:
        def step(params, opt, batch):
            with spans.span("train.loss_and_grad"):
                loss, grads, tok = loss_and_grad(model, params, batch, tc)
                sync(device)
            t = time.perf_counter()
            with spans.span("train.adamw_update"):
                params, opt, metrics = adamw_update(adamw, grads, opt, params)
                sync(device)
            adamw_s.append(time.perf_counter() - t)
            for p in params.parameters():
                p.grad = None
            return params, opt, dict(metrics, loss=loss, token_loss=tok)
    else:
        whole = make_train_step(model, tc)

        def step(params, opt, batch):
            with spans.span("train.step"):
                return whole(params, opt, batch)

    losses, first = [], {}
    for k in range(tr["checked_steps"]):
        params, opt, metrics = step(params, opt,
                                    {"tokens": tokens(ctx, k, device)})
        losses.append(float(metrics["loss"]))
        if k == 0:
            clip = min(1.0, adamw.grad_clip
                       / (float(metrics["grad_norm"]) + 1e-9))
            first = {n: float(torch.linalg.vector_norm(opt.mu[n]))
                     / (1 - adamw.b1) / clip for n in names}
            values = {n: (opt.mu[n].reshape(-1)[sample_index(
                ctx.seed, n, opt.mu[n].numel(), tr["grad_sample"], device)]
                / (1 - adamw.b1) / clip).cpu() for n in names}
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - start[n]))
                  for n, p in params.named_parameters()}
    del start
    adamw_s.clear()

    trace = DeviceTrace(spans) if ctx.trace else contextlib.nullcontext()
    sync(device)
    reset_peak(device)
    with trace:
        sync(device)
        t0, t0_ns = time.perf_counter(), time.perf_counter_ns()
        steps = 0
        while True:
            with spans.span("train.batch"):
                batch = {"tokens": tokens(ctx, tr["checked_steps"] + steps,
                                          device)}
            params, opt, _ = step(params, opt, batch)
            steps += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        sync(device)
        window = time.perf_counter() - t0
    setup_s = t0 - ctx.t_start
    memory = peak_bytes(device)
    summary = trace.summary(window, t0_ns) if ctx.trace else None
    del params, opt, model, step, batch, trace
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_steps(ctx, device)
    got = {"losses": losses, "grad_norms": first, "grad_values": values,
           "change_norms": change}
    checks = compare(got, want, check_leaves(ctx.cell))
    per_step = tr["global_batch"] * tr["seq_len"]
    return RunResult(
        attempted=steps, failed=0,
        end_to_end={"train_tokens_per_s": steps * per_step / window,
                    "setup_s": setup_s},
        counters={"steps": steps, "batch": tr["global_batch"],
                  "seq": tr["seq_len"], "adamw_s": list(adamw_s)},
        checks={k: (v, float(tr["limits"][k])) for k, v in checks.items()},
        memory_peak_bytes=memory, window_s=window, trace=summary,
        lines=[detail(got, want)])


def reference_steps(ctx: RunContext, device, quant=None) -> Dict[str, Any]:
    """The plain reference's checked steps on the run's weights and tokens:
    weights read as the compute dtype holds them, or under `quant`."""
    tr, cfg = ctx.cell.traffic, ctx.cell.config
    return load_reference(cfg["reference"]).train(
        cfg, ctx.seed, [tokens(ctx, k, device)
                        for k in range(tr["checked_steps"])],
        tr["optimizer"], device, quant=quant, sample=tr["grad_sample"],
        weights=None if quant else tr["compute_dtype"])


def check_leaves(cell) -> Dict[str, str]:
    """Number name -> parameter name of the elementwise gradient checks,
    "layers.-1." resolved to the last layer."""
    last = f"layers.{cell.config['num_layers'] - 1}."
    return {k: v.replace("layers.-1.", last)
            for k, v in cell.traffic["check_leaves"].items()}


def _kept(want: Dict[str, Any]) -> list:
    """The parameters compared: those whose reference gradient norm is at
    least NEGLIGIBLE of the median parameter's."""
    ref = want["grad_norms"]
    median = statistics.median(ref.values())
    return [n for n, g in ref.items() if g >= NEGLIGIBLE * median]


def _diff(got: Dict[str, Any], want: Dict[str, Any], name: str) -> float:
    """|program - reference| / |reference| of a parameter's first gradient
    at its sampled elements."""
    g = got["grad_values"][name].double()
    r = want["grad_values"][name].double()
    return float(torch.linalg.vector_norm(g - r)
                 / torch.linalg.vector_norm(r).clamp_min(1e-30))


def compare(got: Dict[str, Any], want: Dict[str, Any],
            leaves: Dict[str, str]) -> Dict[str, float]:
    """The numbers compared for `correct` (see the module's docstring);
    `leaves`: number name -> the parameter whose first gradient it
    compares element by element."""
    ref_grad, ref_change = want["grad_norms"], want["change_norms"]
    kept = _kept(want)
    floor = statistics.median(ref_change[n] for n in kept)
    out = {"grad_norm_gap": statistics.median(
        abs(got["grad_norms"][n] - ref_grad[n]) / ref_grad[n] for n in kept)}
    out.update({k: _diff(got, want, leaf) for k, leaf in leaves.items()})
    out["change_norm_gap"] = max(
        abs(got["change_norms"][n] - ref_change[n])
        / max(ref_change[n], floor) for n in kept)
    return out


def detail(got: Dict[str, Any], want: Dict[str, Any], n: int = 3) -> str:
    """What the numbers compared are made of: the losses, the parameters
    left out, the median parameter's first-gradient difference, and the
    parameters with the largest gaps of norms (program's, reference's)."""
    kept = _kept(want)
    out = {"losses": got["losses"], "reference_losses": want["losses"],
           "left_out": sorted(set(want["grad_norms"]) - set(kept)),
           "grad_diff_median": statistics.median(
               _diff(got, want, k) for k in kept)}
    for key in ("grad_norms", "change_norms"):
        ref = want[key]
        floor = statistics.median(ref[k] for k in kept)
        worst = sorted(kept, key=lambda k: -abs(got[key][k] - ref[k])
                       / max(ref[k], floor))
        out[key] = [[k, got[key][k], ref[k]] for k in worst[:n]]
    return "train check detail: " + json.dumps(out)
