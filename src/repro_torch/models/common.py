"""Shared model building blocks in PyTorch: the config and the primitives.

Counterpart of src/repro/models/common.py.  Weights live in `nn.Module`s
(see transformer.py); these are plain functions on tensors.  Randomness comes
from an explicit `torch.Generator`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------- #
# config
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # attention flavour
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    local_global_pattern: bool = False      # gemma2: alternate local/global
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 / SSD)
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # hybrid (zamba2): shared attention block every k ssm layers
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # vlm (paligemma): prefix-lm over image tokens
    num_image_tokens: int = 0
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    activation: str = "silu"
    mlp_variant: str = "gated"       # gated (SwiGLU/GeGLU) | plain (fc1/fc2)
    sandwich_norm: bool = False      # gemma2 pre+post block norms
    scale_embeddings: bool = False   # gemma-family sqrt(d) embedding scale
    max_seq_len: int = 131_072
    dtype: Any = torch.float32       # compute dtype (bf16 on the card)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count."""
        d, v, l = self.d_model, self.vocab_size, self.num_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din = self.ssm_expand * d
            per = (d * (2 * din + 2 * self.ssm_state_dim) +  # in_proj approx
                   din * d + din)
            return emb + l * per
        att = d * self.num_heads * self.hd + 2 * d * self.num_kv_heads * self.hd \
            + self.num_heads * self.hd * d
        if self.num_experts:
            ff = self.num_experts * 3 * d * self.moe_d_ff \
                + self.num_shared_experts * 3 * d * self.moe_d_ff \
                + d * self.num_experts
        else:
            ff = 3 * d * self.d_ff
        total = emb + l * (att + ff)
        if self.is_encoder_decoder:
            total += self.encoder_layers * (att + 3 * d * self.d_ff) \
                + l * att  # cross attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts count)."""
        if not self.num_experts:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        att = d * self.num_heads * self.hd + 2 * d * self.num_kv_heads * self.hd \
            + self.num_heads * self.hd * d
        ff_active = (self.num_experts_per_tok + self.num_shared_experts) \
            * 3 * d * self.moe_d_ff + d * self.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + l * (att + ff_active)


def resolve_device(device) -> torch.device:
    """The port runs on the card unless asked for the CPU: a CUDA device
    without a card raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


# ---------------------------------------------------------------------- #
# activation-sharding policy (set by the dry run; models stay mesh-free)
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ActivationSharding:
    """One candidate layout of an activation on a DeviceMesh: `spec` has one
    entry per tensor dim, an axis name, a tuple of axis names or None, as
    the reference's PartitionSpec; `placements` is the same layout as one
    Shard or Replicate per mesh dim (`launch.sharding.to_placements`)."""
    mesh: Any
    spec: Tuple[Any, ...]
    placements: Tuple[Any, ...]

    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))


_ACT_SHARDING: Dict[str, Any] = {}


def set_activation_sharding(policy: Optional[Dict[str, Any]]) -> None:
    """policy: {kind: ActivationSharding, or an ordered list of them} for
    the kinds 'residual' [B,S,d], 'logits' [B,S,V], 'attn_qkv' [B,S,H,D],
    'attn_kv_full' and 'moe_tokens' / 'moe_dispatch'.  The dry run installs
    it, as the reference's does, so the batch stays on the data axes
    instead of being replicated; None clears it (the launchers set
    none)."""
    _ACT_SHARDING.clear()
    if policy:
        _ACT_SHARDING.update(policy)


def _divides(shape: Sequence[int], sh: ActivationSharding) -> bool:
    sizes = sh.sizes()
    for dim, names in enumerate(sh.spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        size = 1
        for n in names:
            size *= sizes[n]
        if dim >= len(shape) or shape[dim] % size:
            return False
    return True


def activation_candidate(shape: Sequence[int], kind: str
                         ) -> Optional[ActivationSharding]:
    """The first candidate of `kind` whose named dims divide `shape`, or
    None (no policy, or nothing fits: decode's seq=1, odd vocabs, few
    heads)."""
    cands = _ACT_SHARDING.get(kind)
    if cands is None:
        return None
    if not isinstance(cands, (list, tuple)):
        cands = (cands,)
    for sh in cands:
        if _divides(shape, sh):
            return sh
    return None


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A DTensor x redistributed to the first policy candidate of `kind`
    whose named dims divide its shape; x itself when no policy is set,
    nothing fits, x already has that layout, or x is a plain tensor."""
    from torch.distributed.tensor import DTensor
    if not _ACT_SHARDING or not isinstance(x, DTensor):
        return x
    sh = activation_candidate(x.shape, kind)
    if sh is None or tuple(x.placements) == sh.placements:
        return x
    return x.redistribute(x.device_mesh, sh.placements)


def unsplit_sequence(x: torch.Tensor) -> torch.Tensor:
    """A DTensor [B, S, ...] whose sequence dim is split over a mesh dim
    (the 'residual' policy's sequence parallelism) gathered over it, once,
    before a block's products, which need every row: one all-gather per
    block where DTensor would gather for each projection, and no strided
    layout of the flattened rows for its planner to search.  Anything else
    (a plain tensor, every launcher's path) is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or x.dim() < 3:
        return x
    pl = [Replicate() if p.is_shard() and p.dim == 1 else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def unshard(w: torch.Tensor) -> torch.Tensor:
    """FSDP's unshard: a DTensor weight split over the "data" mesh dim
    gathered there before a product, its other placements ("model"'s
    tensor-parallel split) kept.  Its gradient, a partial sum over "data"
    where the rows are split, is reduce-scattered back to the shards on
    the way back (the redistribute's backward).  Under remat the gather
    runs again in the recomputed forward: FSDP's reshard after forward.
    A plain tensor, or a weight not split over "data", is returned as it
    is, and so is one whose "data" dim has one rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor) or \
            "data" not in w.device_mesh.mesh_dim_names:
        return w
    at = w.device_mesh.mesh_dim_names.index("data")
    if not w.placements[at].is_shard() or w.device_mesh.size(at) == 1:
        return w
    pl = list(w.placements)
    pl[at] = Replicate()
    return w.redistribute(w.device_mesh, pl)


def linear(lin: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`lin(x)` with its weight unsharded first (`unshard`)."""
    return F.linear(x, unshard(lin.weight), lin.bias)


# ---------------------------------------------------------------------- #
# primitives
# ---------------------------------------------------------------------- #

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """fp32 RMS norm scaled by (1 + w): the weights start at zero."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64; callers round them to fp32 once, as
    the reference does (with theta = 1e6 another rounding shows in the
    logits)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half rotary embedding.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    freqs = torch.tensor(rope_freqs(d, theta), dtype=torch.float32,
                         device=x.device)                            # [D/2]
    angles = positions[..., :, None, None].float() * freqs   # [...,S,1,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# init helpers
# ---------------------------------------------------------------------- #

_DRAWS: Optional[list] = None


@contextlib.contextmanager
def recorded_draws():
    """Within it, `dense_init` draws nothing and appends (w, scale, None)
    to the list it yields, and `const_init` fills nothing and appends (w,
    None, value): the order and scales of an init's draws and its constant
    fills, taken on the meta device (`Model.init_leaves` replays them one
    leaf at a time)."""
    global _DRAWS
    outer, _DRAWS = _DRAWS, []
    try:
        yield _DRAWS
    finally:
        _DRAWS = outer


def draw_normal(shape, scale: float, generator: torch.Generator, device
                ) -> torch.Tensor:
    """fp32 normal * scale of `shape` on `device`, as `dense_init` draws."""
    draw = torch.empty(shape, dtype=torch.float32, device=device)
    draw.normal_(generator=generator)
    return draw.mul_(scale)


@torch.no_grad()
def dense_init(w: torch.Tensor, fan_in: int, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Fill w in place with normal * scale (default 1/sqrt(fan_in)), drawn in
    fp32 on w's device and rounded to w's dtype."""
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    if _DRAWS is not None:
        _DRAWS.append((w, float(scale), None))
        return w
    w.copy_(draw_normal(w.shape, scale, generator, w.device))
    return w


@torch.no_grad()
def const_init(w: torch.Tensor, value: float) -> torch.Tensor:
    """Fill w in place with `value` (a weight that starts neither drawn nor
    zero)."""
    if _DRAWS is not None:
        _DRAWS.append((w, None, float(value)))
        return w
    return w.fill_(value)


# ---------------------------------------------------------------------- #
# masks
# ---------------------------------------------------------------------- #

NEG_INF = -2.0 ** 30
