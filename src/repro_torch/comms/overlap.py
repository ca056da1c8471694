"""Bucketed gradient reduction and wire compression on top of the tree
collectives.  Counterpart of src/repro/comms/overlap.py.

* `BucketedAllReduce` — partitions a dict of gradient tensors (in module
  order) into ~equal-byte buckets, in reverse order (gradients become ready
  output-to-input); each bucket is flattened and reduced independently.
  Buckets keep each tree-pipeline transfer long enough to amortise the
  (P+depth)/P pipeline fill of the paper's schedules.
* `compressed_all_reduce` — casts the wire payload (bf16 by default) while
  accumulating in f32 via the tree reduce-scatter's accumulator.

With a `Stacked` comm every tensor leads with the axis's ranks, and buckets
are sized by one rank's bytes, so both comms cut the same buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from .collectives import Stacked, tree_all_reduce
from .executor import PermuteProgram, compile_program

Grads = Dict[str, torch.Tensor]


def partition_buckets(tree: Grads, bucket_bytes: int = 64 << 20
                      ) -> List[List[str]]:
    """Greedy partition of the tensors' names into ~bucket_bytes groups
    (in reverse order — gradients become ready output-to-input).  A tensor
    larger than bucket_bytes is a bucket of its own."""
    names = list(tree)
    buckets: List[List[str]] = [[]]
    size = 0
    for name in reversed(names):
        t = tree[name]
        nbytes = t.numel() * t.element_size()
        if size and size + nbytes > bucket_bytes:
            buckets.append([])
            size = 0
        buckets[-1].append(name)
        size += nbytes
    return buckets


@dataclasses.dataclass
class BucketedAllReduce:
    rs_prog: PermuteProgram
    ag_prog: PermuteProgram
    comm: Any
    bucket_bytes: int = 64 << 20
    wire_dtype: Optional[torch.dtype] = torch.bfloat16

    @classmethod
    def from_schedule(cls, ar: Any, comm, bucket_bytes: int = 64 << 20,
                      wire_dtype: Optional[torch.dtype] = torch.bfloat16
                      ) -> "BucketedAllReduce":
        """Build the gradient hook from ONE `AllReduceSchedule` artifact,
        typically `repro_torch.api.Collectives.schedule(...,
        kind="allreduce")`."""
        return cls(rs_prog=compile_program(ar.rs),
                   ag_prog=compile_program(ar.ag), comm=comm,
                   bucket_bytes=bucket_bytes, wire_dtype=wire_dtype)

    def _lead(self) -> tuple:
        return (self.comm.axis_size,) if isinstance(self.comm, Stacked) \
            else ()

    def reduce_bucket(self, flat: torch.Tensor) -> torch.Tensor:
        """Allreduce one flat bucket ([elems] per rank), cast to the wire
        dtype if one is set, accumulated in f32."""
        if self.wire_dtype is not None:
            flat = flat.to(self.wire_dtype)
        return tree_all_reduce(flat, self.rs_prog, self.ag_prog, self.comm,
                               accum_dtype=torch.float32)

    def __call__(self, grads: Grads) -> Grads:
        lead = self._lead()
        out: Grads = {}
        # buckets are sized by one rank's bytes
        per_rank = {k: (v[0] if lead else v) for k, v in grads.items()}
        for bucket in partition_buckets(per_rank, self.bucket_bytes):
            flat = torch.cat([grads[k].reshape(lead + (-1,))
                              for k in bucket], dim=-1)
            red = self.reduce_bucket(flat)
            del flat
            off = 0
            for k in bucket:
                shape = grads[k].shape
                n = per_rank[k].numel()
                out[k] = red[..., off:off + n].reshape(shape).to(
                    grads[k].dtype)
                off += n
        return {k: out[k] for k in grads}


def compressed_all_reduce(x: torch.Tensor, rs_prog: PermuteProgram,
                          ag_prog: PermuteProgram, comm,
                          wire_dtype=torch.bfloat16) -> torch.Tensor:
    """All-reduce with a bf16 (or other) wire payload and f32
    accumulation."""
    return tree_all_reduce(x.to(wire_dtype), rs_prog, ag_prog, comm,
                           accum_dtype=torch.float32).to(x.dtype)
