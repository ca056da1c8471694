"""Mamba2 (state-space duality / SSD): chunked prefill and O(1) decode.
Counterpart of src/repro/models/ssm.py.

The SSD recurrence per head (state [P, N], input x_t [P], B_t, C_t [N]):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t
    y_t = h_t @ C_t + D x_t

Prefill of a prompt whose length is a multiple of the chunk uses the chunked
block decomposition: the intra-chunk term and each chunk's terminal state
(steps 1 and 2) come from the hand-written SSD kernel on the card
(`repro_torch.kernels.ssd_chunk_intra_bshp`), the inter-chunk recurrence and
the read-out of the carried state (steps 3 and 4) from plain ops.  Any other
prompt, and decode, take the sequential recurrence `ssd_reference`, as in
the reference.  Decode keeps (conv_state, ssm_state) per layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ops import ssd_chunk_intra_bshp

from .common import ModelConfig, dense_init, rms_norm

SSMState = Tuple[torch.Tensor, torch.Tensor]     # (conv, ssm)


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, num_heads, head_dim, state_dim)."""
    din = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    h = cfg.ssm_num_heads or din // p
    return din, h, p, cfg.ssm_state_dim


class Mamba2(nn.Module):
    """The mixer's weights: in_proj and out_proj as bias-free `nn.Linear`s
    ([out, in] weights), conv_w [W, C] as the reference keeps it (a
    depthwise cross-correlation over W taps), and per-head A_log, D,
    dt_bias."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None):
        super().__init__()
        din, h, _, n = ssm_dims(cfg)
        d = cfg.d_model
        conv_dim = din + 2 * n                  # x, B, C share the conv
        kw = dict(dtype=dtype, device=device)
        self.in_proj = nn.Linear(d, 2 * din + 2 * n + h, bias=False, **kw)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv_width, conv_dim,
                                               **kw))
        self.conv_b = nn.Parameter(torch.empty(conv_dim, **kw))
        self.A_log = nn.Parameter(torch.empty(h, **kw))
        self.D = nn.Parameter(torch.empty(h, **kw))
        self.dt_bias = nn.Parameter(torch.empty(h, **kw))
        self.norm_w = nn.Parameter(torch.empty(din, **kw))
        self.out_proj = nn.Linear(din, d, bias=False, **kw)


@torch.no_grad()
def init_mamba2(p: Mamba2, generator: torch.Generator) -> None:
    """The reference's init: normal projections, conv taps * 0.5,
    A = -exp(0) = -1, D = 1, zero biases and norm."""
    dense_init(p.in_proj.weight, p.in_proj.in_features, generator)
    dense_init(p.conv_w, p.conv_w.shape[0], generator, scale=0.5)
    dense_init(p.out_proj.weight, p.out_proj.in_features, generator)
    for w in (p.conv_b, p.A_log, p.dt_bias, p.norm_w):
        w.zero_()
    p.D.fill_(1.0)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., Q, H] -> [..., H, Q, Q] lower-triangular pairwise sums:
    out[i, j] = sum_{j < t <= i} x[t]  (i >= j), -inf above diagonal."""
    q = x.shape[-2]
    cs = torch.cumsum(x, dim=-2)                              # [..., Q, H]
    diff = cs[..., :, None, :] - cs[..., None, :, :]          # [..., i, j, H]
    diff = torch.movedim(diff, -1, -3)                        # [..., H, i, j]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.
    x: [B,S,H,P], dt: [B,S,H] (>0), a: [H] (<0), b,c: [B,S,N].
    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] float32).

    Steps 1 and 2 (the intra-chunk output and each chunk's state) run in
    float32 inside the SSD kernel on the card, or its plain version on the
    CPU and under autograd; the reference runs them in the input dtype, so
    in bf16 the two differ by bf16 roundings, and in float32 they agree.
    Steps 3 and 4 follow the reference: a float32 carry, emitted and read
    out in the input dtype."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    cdt = x.dtype                                             # compute dtype
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    l = s // chunk
    dt = dt.float()
    a = a.float()
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a, b, c))

    # 1, 2. intra-chunk output and per-chunk terminal states
    y_diag, states = ssd_chunk_intra_bshp(x, dt, a, b.to(cdt), c.to(cdt),
                                          chunk, plain=needs_grad)

    # 3. inter-chunk recurrence (f32 carry; emits in compute dtype)
    da_cs = torch.cumsum((dt * a).reshape(bs, l, chunk, h), dim=2)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])               # [B,L,H] f32
    carry = init_state.float() if init_state is not None else \
        torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for i in range(l):
        entering.append(carry.to(cdt))                        # emit entering
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    entering = torch.stack(entering, dim=1)                   # [B,L,H,P,N]

    # 4. off-diagonal: prior state read out through intra-chunk decay
    state_decay = torch.exp(da_cs).to(cdt)                    # [B,L,Q,H]
    c_c = c.to(cdt).reshape(bs, l, chunk, n)
    y_off = torch.einsum("blqn,blhpn,blqh->blqhp", c_c, entering, state_decay)
    return y_diag + y_off.reshape(bs, s, h, p), carry


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential recurrence: the oracle for ssd_chunked, and the path
    of decode and of prompts the chunk does not divide.  A Python loop over
    S: fine for decode (S = 1), slow for long prompts."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    state = init_state if init_state is not None else \
        torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None, :])[..., None, None]   # [B,H,1,1]
        upd = (x[:, t] * dt[:, t, :, None])[..., None] \
            * b[:, t, None, None, :]
        state = state * decay + upd                           # [B,H,P,N]
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; x: [B,S,C], w: [W,C].  Returns (silu(y),
    new_state) where the state is the last W-1 inputs (for decode).
    Prefill is `F.conv1d` with groups = C, a cross-correlation like the
    reference's `lax.conv_general_dilated` (the taps are not flipped), with
    cuDNN's TF32 off so a float32 conv stays float32."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)                         # [B,S+W-1,C]
    new_state = full[:, -(width - 1):, :]
    if x.shape[1] == 1:
        # decode: one dot against the window
        y = torch.einsum("bwc,wc->bc", full, w)[:, None, :] + bias
        return F.silu(y), new_state
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(full.transpose(1, 2), w.T[:, None, :],
                     groups=x.shape[2])
    # back to [B,S,C] in memory: the SSD kernel reads x, b and c with their
    # channels contiguous
    return F.silu(y.transpose(1, 2).contiguous() + bias), new_state


def mamba2_forward(p: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                   state: Optional[SSMState] = None
                   ) -> Tuple[torch.Tensor, SSMState]:
    """Full Mamba2 mixer.  x: [B,S,d].  state = (conv_state, ssm_state) for
    incremental decode (S small, typically 1).  Returns (out, new_state)."""
    din, h, pdim, n = ssm_dims(cfg)
    conv_state, ssm_state = state if state is not None else (None, None)

    proj = p.in_proj(x)                                       # [B,S,...]
    z, xbc, dt_raw = torch.split(proj, [din, din + 2 * n, h], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())       # [B,S,H]
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xs, b, c = torch.split(xbc, [din, n, n], dim=-1)
    xs = xs.reshape(x.shape[0], x.shape[1], h, pdim)
    a = -torch.exp(p.A_log.float())

    if x.shape[1] % cfg.ssm_chunk == 0 and x.shape[1] >= cfg.ssm_chunk:
        # steps 1 and 2 in the SSD kernel on the card
        y, new_ssm = ssd_chunked(xs, dt, a, b, c, cfg.ssm_chunk, ssm_state)
    else:
        y, new_ssm = ssd_reference(xs.float(), dt, a, b.float(), c.float(),
                                   ssm_state)
    y = y.float() + xs.float() * p.D.float()[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    return p.out_proj(y), (new_conv, new_ssm)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda") -> SSMState:
    """Zeroed (conv [B,W-1,C] in dtype, ssm [B,H,P,N] float32)."""
    din, h, pdim, n = ssm_dims(cfg)
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, din + 2 * n),
                       dtype=dtype, device=device)
    ssm = torch.zeros((batch, h, pdim, n), dtype=torch.float32,
                      device=device)
    return conv, ssm
