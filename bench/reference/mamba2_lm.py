"""Plain float32 reference of the Mamba2 family as the port runs it
(Mamba2-780m: embedding, Mamba2 layers, final norm, tied head).

Its parameters carry the port's names, shapes and module order
(`layout`), which is also the gradient set that a data-parallel step
hands its gradient hook.  `make_weights` draws them from a seed on the
device in one call.  `loss` is the next-token cross-entropy in float32
(TF32 off), each layer recomputed in the backward pass so that it fits;
`adamw` is the port's optimizer formula; `train` runs steps and returns
what the train cells compare.  Norms scale by (1 + w).

`weights="bfloat16"` reads every parameter rounded to bfloat16 in the
forward pass, as a step that computes in bf16 from float32 masters does,
and hands the gradients to the float32 masters unchanged; the arithmetic
stays float32.

`quant="fp8"` computes in float8 e4m3 where the program computes in
bf16: every projection's operands, the residual stream, the mixer's
activations, and their gradients, each rounded under a per-tensor scale
(float32 accumulation, as bf16 products have).  It is the control that a
lower precision than the configuration's must fail.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.seeds import generator, sample_index

Cfg = Dict[str, Any]
Weights = Dict[str, torch.Tensor]
LOSS_BLOCK = 1024       # sequence positions per block of the loss


def dims(cfg: Cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state dim) of the Mamba2 mixer."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    p = cfg["ssm_head_dim"]
    return din, din // p, p, cfg["ssm_state_dim"]


def layout(cfg: Cfg) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """(name, shape, init) of every parameter in module order; init is
    ("normal", scale), ("zeros",) or ("const", value)."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    din, h, _, n = dims(cfg)
    conv = din + 2 * n
    zeros = ("zeros",)
    out = [("embed", (v, d), ("normal", 0.02)), ("final_norm", (d,), zeros)]
    for i in range(cfg["num_layers"]):
        at = f"layers.{i}."
        out += [(at + "ln", (d,), zeros),
                (at + "mamba.conv_w", (cfg["ssm_conv_width"], conv),
                 ("normal", 0.5)),
                (at + "mamba.conv_b", (conv,), zeros),
                (at + "mamba.A_log", (h,), zeros),
                (at + "mamba.D", (h,), ("const", 1.0)),
                (at + "mamba.dt_bias", (h,), zeros),
                (at + "mamba.norm_w", (din,), zeros),
                (at + "mamba.in_proj.weight", (2 * din + 2 * n + h, d),
                 ("normal", d ** -0.5)),
                (at + "mamba.out_proj.weight", (d, din),
                 ("normal", din ** -0.5))]
    return out


def make_weights(cfg: Cfg, seed: int, device) -> Weights:
    """Every parameter from `seed`, float32 on `device`: the drawn ones in
    one normal draw, scaled per parameter."""
    lay = layout(cfg)
    drawn = sum(math.prod(s) for _, s, init in lay if init[0] == "normal")
    flat = torch.empty(drawn, dtype=torch.float32, device=device)
    flat.normal_(generator=generator(device, seed, "weights"))
    out: Weights = {}
    at = 0
    for name, shape, init in lay:
        n = math.prod(shape)
        if init[0] == "normal":
            out[name] = flat[at:at + n].view(shape).mul_(init[1])
            at += n
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            out[name] = torch.full(shape, init[1], dtype=torch.float32,
                                   device=device)
    return out


# ---------------------------------------------------------------------- #
# forward
# ---------------------------------------------------------------------- #

def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale."""
    scale = 448.0 / t.abs().amax().float().clamp_min(1e-30)
    return ((t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale)


class _RoundFP8(torch.autograd.Function):
    """Identity whose value and gradient are rounded to float8 e4m3."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def _r(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """An activation (and its gradient) as the computing precision holds
    it: float32, or float8 under quant="fp8"."""
    return _RoundFP8.apply(t) if quant == "fp8" else t


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
        ) -> torch.Tensor:
    """x @ w.T, w [out, in]."""
    return _r(x, quant) @ _r(w, quant).T


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal cross-correlation: x [B,S,C], w [W,C]."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(w[k] * xp[:, k:k + s] for k in range(width)) + b


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """y_t = C_t . h_t, h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t from a
    zero state, by chunks.  x [B,S,H,P], dt [B,S,H], a [H], b, c [B,S,N];
    the decays' cumulative sums in float64."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of {chunk}")
    nc = s // chunk
    x = x.reshape(bs, nc, chunk, h, p)
    dt = dt.reshape(bs, nc, chunk, h)
    b = b.reshape(bs, nc, chunk, n)
    c = c.reshape(bs, nc, chunk, n)
    cum = torch.cumsum((dt * a).double(), dim=2)            # [B,L,Q,H]
    seg = (cum[:, :, :, None] - cum[:, :, None]).float()    # [B,L,i,j,H]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay_ij = torch.exp(torch.where(tril[:, :, None], seg, -torch.inf))
    scores = torch.einsum("blin,bljn->blij", c, b)
    xdt = x * dt[..., None]                                 # [B,L,Q,H,P]
    y = torch.einsum("blijh,bljhp->blihp", scores[..., None] * decay_ij, xdt)
    to_end = torch.exp((cum[:, :, -1:] - cum).float())      # [B,L,Q,H]
    states = torch.einsum("bljhp,bljn->blhpn", xdt * to_end[..., None], b)
    chunk_decay = torch.exp(cum[:, :, -1].float())          # [B,L,H]
    carry = torch.zeros(bs, h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    entering = torch.stack(entering, dim=1)                 # [B,L,H,P,N]
    from_start = torch.exp(cum.float())                     # [B,L,Q,H]
    y = y + torch.einsum("blqn,blhpn,blqh->blqhp", c, entering, from_start)
    return y.reshape(bs, s, h, p)


def mixer(x: torch.Tensor, w: Weights, at: str, cfg: Cfg,
          quant: Optional[str]) -> torch.Tensor:
    din, h, p, n = dims(cfg)
    bs, s, _ = x.shape
    z, xbc, dt = torch.split(_r(_mm(x, w[at + "in_proj.weight"], quant),
                                quant), [din, din + 2 * n, h], dim=-1)
    dt = F.softplus(dt + w[at + "dt_bias"])
    xbc = _r(F.silu(causal_conv(xbc, w[at + "conv_w"], w[at + "conv_b"])),
             quant)
    xs, b, c = torch.split(xbc, [din, n, n], dim=-1)
    xs = xs.reshape(bs, s, h, p)
    y = ssd(xs, dt, -torch.exp(w[at + "A_log"]), b, c, cfg["ssm_chunk"])
    y = _r(y + xs * w[at + "D"][:, None], quant).reshape(bs, s, din) \
        * F.silu(z)
    y = rms_norm(y, w[at + "norm_w"], cfg["norm_eps"])
    return _mm(y, w[at + "out_proj.weight"], quant)


def loss(w: Weights, cfg: Cfg, tokens: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over tokens [B,S] (the last position
    predicts nothing)."""
    eps = cfg["norm_eps"]
    if cfg["family"] != "ssm":
        raise ValueError(f"no reference for family {cfg['family']!r}")
    h = _r(w["embed"][tokens], quant)
    for i in range(cfg["num_layers"]):
        at = f"layers.{i}."
        h = checkpoint(lambda x, at=at: _r(x + mixer(
            rms_norm(x, w[at + "ln"], eps), w, at + "mamba.", cfg, quant),
            quant), h, use_reentrant=False)
    bs, s = tokens.shape
    h = rms_norm(h, w["final_norm"], eps)[:, :-1]
    labels = tokens[:, 1:]

    def block_nll(hb: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
        logits = _mm(hb, w["embed"], quant)
        gold = torch.gather(logits, -1, lb[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    total = sum(checkpoint(block_nll, h[:, i:i + LOSS_BLOCK],
                           labels[:, i:i + LOSS_BLOCK], use_reentrant=False)
                for i in range(0, s - 1, LOSS_BLOCK))
    return total / (bs * (s - 1))


# ---------------------------------------------------------------------- #
# optimizer and training
# ---------------------------------------------------------------------- #

def lr_at(opt: Dict[str, float], step: int) -> float:
    """Linear warm-up, then cosine decay to min_lr_ratio, in float32."""
    f = np.float32
    warm = min(f(1.0), f(step + 1) / f(max(opt["warmup_steps"], 1)))
    frac = np.clip(f(step - opt["warmup_steps"])
                   / f(max(opt["total_steps"] - opt["warmup_steps"], 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * frac))
    low = f(opt["min_lr_ratio"])
    return float(f(opt["lr"]) * warm * (low + (f(1) - low) * cos))


@torch.no_grad()
def adamw(w: Weights, grads: Weights, mu: Weights, nu: Weights, step: int,
          opt: Dict[str, float]) -> float:
    """AdamW step `step` (0-based): global-norm clipping, decoupled weight
    decay on parameters of two or more dims.  Updates w, mu, nu in place;
    returns the gradients' global norm before clipping."""
    gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9))
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    lr = lr_at(opt, step)
    for name, p in w.items():
        g = grads[name] * scale
        mu[name].mul_(b1).add_((1 - b1) * g)
        nu[name].mul_(b2).add_((1 - b2) * g * g)
        delta = (mu[name] / b1c) / ((nu[name] / b2c).sqrt() + opt["eps"])
        if p.dim() >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return float(gnorm)


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32 within."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _held_as(w: Weights, dtype: Optional[str]) -> Weights:
    """w as the forward pass reads it: rounded to `dtype`, with the
    gradient passed to w unchanged."""
    if dtype in (None, "float32"):
        return w
    d = getattr(torch, dtype)
    return {k: t + (t.detach().to(d).float() - t.detach())
            for k, t in w.items()}


def train(cfg: Cfg, seed: int, batches: Sequence[torch.Tensor],
          opt: Dict[str, float], device, quant: Optional[str] = None,
          sample: int = 0, weights: Optional[str] = None) -> Dict[str, Any]:
    """len(batches) AdamW steps from `make_weights(cfg, seed)`, the forward
    pass reading the weights as `weights` ("bfloat16"; None or "float32":
    float32) holds them.  Returns each step's loss, each parameter's first
    gradient norm (before clipping) and its values at `sample` elements
    drawn from the seed (`seeds.sample_index`), and each parameter's change
    norm after the last step."""
    w = {k: t.clone().requires_grad_() for k, t in
         make_weights(cfg, seed, device).items()}
    mu = {k: torch.zeros_like(t) for k, t in w.items()}
    nu = {k: torch.zeros_like(t) for k, t in w.items()}
    losses, first, values = [], {}, {}
    with exact_float32():
        for step, tokens in enumerate(batches):
            value = loss(_held_as(w, weights), cfg, tokens, quant)
            grads = dict(zip(w, torch.autograd.grad(value, list(w.values()))))
            losses.append(float(value.detach()))
            if step == 0:
                first = {k: float(torch.linalg.vector_norm(g))
                         for k, g in grads.items()}
                values = {k: g.reshape(-1)[sample_index(
                    seed, k, g.numel(), sample, device)].cpu()
                    for k, g in grads.items()}
            adamw(w, grads, mu, nu, step, opt)
            del grads, value
    del mu, nu
    start = make_weights(cfg, seed, device)
    change = {k: float(torch.linalg.vector_norm(w[k].detach() - start[k]))
              for k in w}
    return {"losses": losses, "grad_norms": first, "grad_values": values,
            "change_norms": change}
