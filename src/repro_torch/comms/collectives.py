"""Tree-pipeline collectives: the paper's bandwidth-optimal schedules run as
static permute programs.  Counterpart of src/repro/comms/collectives.py.

`tree_all_gather`, `tree_reduce_scatter`, `tree_all_to_all`,
`tree_broadcast`, `tree_reduce`, `tree_all_reduce` and
`tree_all_reduce_multi` match the reference's functions of the same names
bit for bit: the same buffer layout, the same program, the same float32
arithmetic in the same order.  Where the reference runs inside `shard_map`
over a mesh axis, these take a `comm` that says how the ranks of the axis
are held:

* `P2P(group)`: one rank per process, each with its own buffer; a
  `PermuteCall` becomes one `torch.distributed.batch_isend_irecv` group
  (gloo on the CPU, NCCL on cards).  Tensors are this rank's.
* `Stacked(A)`: all A ranks in one process, their tensors stacked along a
  leading dimension of size A on one device; a `PermuteCall` becomes an
  index over that dimension.  It runs the same programs with the same
  arithmetic where one device must stand for the whole axis (one card, as
  the reference does with forced host devices).

Data layout: the per-rank shard is flattened and padded to
`slots_per_shard` equal chunks; the working buffer is
[axis_size * slots_per_shard + 1, chunk_elems] per rank, the last row a
trash row.  Each call gathers its send rows, moves them to the receivers,
and lands them: a copy for allgather, alltoall and broadcast, and for
reduce-scatter and reduce the float32 add of
`repro_torch.kernels.chunk_accum_indexed` (the comm's `accumulate`).
Ranks that receive nothing in a call take no part in it.  bf16/f16 inputs
are reduced in float32 (the whole buffer is upcast before the rounds, so
payloads travel in float32), as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import chunk_accum_indexed

from .executor import PermuteCall, PermuteProgram

Accumulate = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                      torch.Tensor]


def _index_tensors(arrays: List[np.ndarray], device) -> List[torch.Tensor]:
    """Many small int64 index arrays moved to `device` in one copy."""
    if not arrays:
        return []
    sizes = [len(a) for a in arrays]
    flat = torch.from_numpy(np.concatenate(arrays).astype(np.int64))
    return list(torch.split(flat.to(device), sizes))


class Stacked:
    """All `axis_size` ranks of an axis in this process: every tensor carries
    the ranks as its leading dimension.  `accumulate(acc, idx, rows, skip)`
    lands reduce-scatter payloads (the kernel by default; its plain version
    to hold the kernel against)."""

    def __init__(self, axis_size: int,
                 accumulate: Accumulate = chunk_accum_indexed):
        self.axis_size = axis_size
        self.ranks: Tuple[int, ...] = tuple(range(axis_size))
        self.accumulate = accumulate

    def local(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0 or x.shape[0] != self.axis_size:
            raise ValueError(f"stacked tensors lead with the {self.axis_size} "
                             f"ranks; got shape {tuple(x.shape)}")
        return x

    def unlocal(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def bind(self, prog: PermuteProgram, rows: int, device):
        """Per call: (rows to read, rows to write) of the [A * rows, chunk]
        buffer, one entry for each (sender, receiver, layer)."""
        arrays = []
        for rnd in prog.rounds:
            for call in rnd:
                src = np.array([s for s, _ in call.perm])
                dst = np.array([d for _, d in call.perm])
                arrays.append((src[:, None] * rows
                               + call.send_slots[src]).ravel())
                arrays.append((dst[:, None] * rows
                               + call.recv_slots[dst]).ravel())
        t = _index_tensors(arrays, device)
        return list(zip(t[0::2], t[1::2]))

    def move(self, flat: torch.Tensor, call: PermuteCall, bound
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        read, write = bound
        return flat.index_select(0, read), write


class P2P:
    """One rank of the axis per process, over a `torch.distributed` process
    group (None: the default group), whose ranks are the program's device
    ids.  `accumulate` as for `Stacked`.  Every rank of the group constructs
    its P2P together: construction is a barrier, because NCCL needs all
    ranks of a group in its first call and a program's first call may leave
    some out."""

    def __init__(self, group=None,
                 accumulate: Accumulate = chunk_accum_indexed):
        self.group = group
        self.axis_size = dist.get_world_size(group)
        self.me = dist.get_rank(group)
        self.ranks: Tuple[int, ...] = (self.me,)
        self.accumulate = accumulate
        dist.barrier(group=group)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[None]

    def unlocal(self, y: torch.Tensor) -> torch.Tensor:
        return y[0]

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def bind(self, prog: PermuteProgram, rows: int, device):
        """Per call: (rows to send, peer, rows to receive into, peer), with
        None where this rank does not send or receive."""
        me, arrays, plan = self.me, [], []
        for rnd in prog.rounds:
            for call in rnd:
                to = [d for s, d in call.perm if s == me]
                frm = [s for s, d in call.perm if d == me]
                if to:
                    arrays.append(call.send_slots[me])
                if frm:
                    arrays.append(call.recv_slots[me])
                plan.append((to, frm))
        it = iter(_index_tensors(arrays, device))
        return [(next(it) if to else None, to[0] if to else None,
                 next(it) if frm else None, frm[0] if frm else None)
                for to, frm in plan]

    def move(self, flat: torch.Tensor, call: PermuteCall, bound
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        send_rows, to, recv_rows, frm = bound
        ops = []
        if send_rows is not None:
            ops.append(dist.P2POp(dist.isend, flat.index_select(0, send_rows),
                                  self._peer(to), self.group))
        got = None
        if recv_rows is not None:
            got = torch.empty((call.width, flat.shape[1]), dtype=flat.dtype,
                              device=flat.device)
            ops.append(dist.P2POp(dist.irecv, got, self._peer(frm),
                                  self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got, recv_rows


def _run_program(buf: torch.Tensor, prog: PermuteProgram, comm,
                 mode: str) -> torch.Tensor:
    """buf: [local ranks, A * S + 1, chunk], updated in place."""
    if comm.axis_size != prog.axis_size:
        raise ValueError(f"program for {prog.axis_size} ranks run over "
                         f"{comm.axis_size}")
    rows = buf.shape[1]
    flat = buf.view(-1, buf.shape[2])
    calls = [call for rnd in prog.rounds for call in rnd]
    for call, bound in zip(calls, comm.bind(prog, rows, buf.device)):
        got, idx = comm.move(flat, call, bound)
        if got is None:
            continue
        if mode == "set":
            flat.index_copy_(0, idx, got)
        else:
            comm.accumulate(flat, idx, got, prog.num_slots)
    return buf


def _chunk_elems(shard_elems: int, slots: int) -> int:
    return -(-shard_elems // slots)  # ceil


def _stage(buf: torch.Tensor, flat: torch.Tensor, comm, s: int) -> None:
    """Each local rank's own shard, flat [local, elems], into the head of
    its rows [me * S, (me + 1) * S); the rest stays zero (the padding)."""
    for i, r in enumerate(comm.ranks):
        buf[i, r * s:(r + 1) * s].view(-1)[:flat.shape[1]] = flat[i]


# ---------------------------------------------------------------------- #
# allgather
# ---------------------------------------------------------------------- #

def tree_all_gather(x: torch.Tensor, prog: PermuteProgram, comm, *,
                    tiled: bool = False) -> torch.Tensor:
    """Bandwidth-optimal pipelined allgather of each rank's shard `x`.

    Returns [A, *x.shape] per rank (or concatenated along axis 0 when
    tiled=True), matching `lax.all_gather` semantics."""
    if prog.kind != "allgather":
        raise ValueError(f"program kind {prog.kind} != allgather")
    a, s = prog.axis_size, prog.slots_per_shard
    xl = comm.local(x)
    n, shape = xl.shape[0], xl.shape[1:]
    shard_elems = math.prod(shape)
    ce = _chunk_elems(shard_elems, s)
    buf = torch.zeros((n, a * s + 1, ce), dtype=x.dtype, device=x.device)
    _stage(buf, xl.reshape(n, shard_elems), comm, s)
    buf = _run_program(buf, prog, comm, "set")
    # a view of buf: rank j's shard is the head of its S rows
    out = buf[:, :a * s].view(n, a, s * ce)[:, :, :shard_elems]
    out = out.reshape((n, a) + shape)
    if tiled and len(shape):
        out = out.reshape((n, a * shape[0]) + shape[1:])
    return comm.unlocal(out)


# ---------------------------------------------------------------------- #
# reduce-scatter
# ---------------------------------------------------------------------- #

def tree_reduce_scatter(x: torch.Tensor, prog: PermuteProgram, comm, *,
                        accum_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Bandwidth-optimal pipelined reduce-scatter.

    Each rank's `x` has leading dim A*<shard>; returns that rank's reduced
    shard (shape [shard, ...]), matching `lax.psum_scatter(tiled=True)`."""
    if prog.kind != "reduce_scatter":
        raise ValueError(f"program kind {prog.kind} != reduce_scatter")
    a, s = prog.axis_size, prog.slots_per_shard
    xl = comm.local(x)
    n = xl.shape[0]
    if xl.dim() < 2 or xl.shape[1] % a:
        raise ValueError(f"leading dim of {tuple(x.shape)} per rank not "
                         f"divisible by {a}")
    shard_shape = (xl.shape[1] // a,) + xl.shape[2:]
    shard_elems = math.prod(shard_shape)
    ce = _chunk_elems(shard_elems, s)
    compute_dtype = accum_dtype or (
        torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
        else x.dtype)
    buf = torch.zeros((n, a * s + 1, ce), dtype=compute_dtype,
                      device=x.device)
    staged = buf[:, :a * s].view(n, a, s * ce)
    staged[:, :, :shard_elems] = xl.reshape(n, a, shard_elems)
    buf = _run_program(buf, prog, comm, "add")
    mine = torch.stack([buf[i, r * s:(r + 1) * s]
                        for i, r in enumerate(comm.ranks)])
    out = mine.reshape(n, s * ce)[:, :shard_elems]
    return comm.unlocal(out.reshape((n,) + shard_shape).to(x.dtype))


# ---------------------------------------------------------------------- #
# alltoall (per-source pruned scatter over the packed spanning trees)
# ---------------------------------------------------------------------- #

def tree_all_to_all(x: torch.Tensor, prog: PermuteProgram, comm
                    ) -> torch.Tensor:
    """Bandwidth-optimal pipelined all-to-all of each rank's destination
    blocks.

    Each rank's `x` is [A, *block]: ``x[w]`` is its block for destination
    ``w``.  Returns [A, *block] per rank with ``out[r]`` = source r's block
    for that rank, matching ``jax.lax.all_to_all(x, axis, 0, 0)`` (under
    `Stacked`, ``x.transpose(0, 1)``).

    Alltoall programs fold the destination into the slot index
    (slots_per_shard = A·k·P; slot = dest·k·P + subslot), so each source's
    whole send buffer is staged at rows [me·S, (me+1)·S) in
    destination-major order, ``kp = S / A`` subslots per block.  The
    diagonal block never travels: it stays where its rank staged it, and
    the output reads it back from there.  Source r's block for rank me sits
    at rows r·S + me·kp + t."""
    if prog.kind != "alltoall":
        raise ValueError(f"program kind {prog.kind} != alltoall")
    a, s = prog.axis_size, prog.slots_per_shard
    xl = comm.local(x)
    n = xl.shape[0]
    if xl.dim() < 2 or xl.shape[1] != a:
        raise ValueError(f"per-rank leading dim of {tuple(x.shape)} != axis "
                         f"size {a}")
    kp = s // a                       # subslots per destination block (k·P)
    block_shape = xl.shape[2:]
    block_elems = math.prod(block_shape)
    ce = _chunk_elems(block_elems, kp)
    flat = xl.reshape(n, a, block_elems)
    if kp * ce != block_elems:        # each block padded to its kp chunks
        flat = torch.nn.functional.pad(flat, (0, kp * ce - block_elems))
    buf = torch.zeros((n, a * s + 1, ce), dtype=x.dtype, device=x.device)
    _stage(buf, flat.reshape(n, s * ce), comm, s)
    buf = _run_program(buf, prog, comm, "set")
    rows = buf[:, :a * s].view(n, a, a, kp * ce)     # [n, src, dest, block]
    out = torch.stack([rows[i, :, r] for i, r in enumerate(comm.ranks)])
    out = out[:, :, :block_elems].reshape((n, a) + block_shape)
    return comm.unlocal(out)


# ---------------------------------------------------------------------- #
# broadcast / reduce (paper Appendix A and its edge-reversed dual)
# ---------------------------------------------------------------------- #

def _stage_root(buf: torch.Tensor, flat: torch.Tensor, root: int,
                s: int) -> None:
    """Every local rank's own copy, flat [local, elems], into the head of
    the root's rows [root * S, (root + 1) * S); only the root's is ever
    forwarded."""
    n, elems = flat.shape
    buf[:, root * s:(root + 1) * s].view(n, -1)[:, :elems] = flat


def _root_rows(buf: torch.Tensor, x_local: torch.Tensor, root: int,
               s: int) -> torch.Tensor:
    n = buf.shape[0]
    elems = math.prod(x_local.shape[1:])
    out = buf[:, root * s:(root + 1) * s].view(n, -1)[:, :elems]
    return out.reshape(x_local.shape)


def tree_broadcast(x: torch.Tensor, prog: PermuteProgram, comm
                   ) -> torch.Tensor:
    """Bandwidth-optimal pipelined broadcast of the root's buffer `x`.

    Every rank passes an `x` of the same shape (non-root values are
    ignored, as in MPI_Bcast); every rank returns the root's `x`.  A rank
    only ever sends chunks it received, so non-root data never travels."""
    if prog.kind != "broadcast":
        raise ValueError(f"program kind {prog.kind} != broadcast")
    a, s, root = prog.axis_size, prog.slots_per_shard, prog.root
    xl = comm.local(x)
    n = xl.shape[0]
    ce = _chunk_elems(math.prod(xl.shape[1:]), s)
    buf = torch.zeros((n, a * s + 1, ce), dtype=x.dtype, device=x.device)
    _stage_root(buf, xl.reshape(n, -1), root, s)
    buf = _run_program(buf, prog, comm, "set")
    return comm.unlocal(_root_rows(buf, xl, root, s))


def tree_reduce(x: torch.Tensor, prog: PermuteProgram, comm, *,
                accum_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bandwidth-optimal pipelined reduce (sum) of `x` to the root.

    Every rank contributes its `x`; the result is the sum over ranks on the
    root and an intermediate partial elsewhere (MPI_Reduce semantics).
    Each hop adds the incoming partial into its own (the comm's
    `accumulate`: `chunk_accum` on the card), in float32 for bf16/f16
    inputs, so a rank forwards one partial per chunk slot."""
    if prog.kind != "reduce":
        raise ValueError(f"program kind {prog.kind} != reduce")
    a, s, root = prog.axis_size, prog.slots_per_shard, prog.root
    xl = comm.local(x)
    n = xl.shape[0]
    ce = _chunk_elems(math.prod(xl.shape[1:]), s)
    compute_dtype = accum_dtype or (
        torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
        else x.dtype)
    buf = torch.zeros((n, a * s + 1, ce), dtype=compute_dtype,
                      device=x.device)
    _stage_root(buf, xl.reshape(n, -1), root, s)
    buf = _run_program(buf, prog, comm, "add")
    return comm.unlocal(_root_rows(buf, xl, root, s).to(x.dtype))


# ---------------------------------------------------------------------- #
# allreduce = RS + AG (paper Appendix B)
# ---------------------------------------------------------------------- #

def _split_ranks(x: torch.Tensor, a: int, comm
                 ) -> Tuple[torch.Tensor, int]:
    """x per rank -> [A, ceil(elems / A)] per rank, zero padded: the
    reference's pad -> reshape(a, ...)."""
    xl = comm.local(x)
    n = xl.shape[0]
    elems = math.prod(xl.shape[1:])
    pad = (-elems) % a
    flat = xl.reshape(n, elems)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return comm.unlocal(flat.reshape(n, a, (elems + pad) // a)), elems


def _join_ranks(full: torch.Tensor, x: torch.Tensor, elems: int, comm
                ) -> torch.Tensor:
    """The gathered [A, 1, m] pieces per rank -> x's shape: the first
    `elems` of their concatenation, in one copy."""
    fl = comm.local(full)
    n, a, m = fl.shape[0], fl.shape[1], fl.shape[-1]
    fl = fl.reshape(n, a, m)
    out = torch.empty(comm.local(x).shape, dtype=fl.dtype, device=fl.device)
    dst = out.view(n, elems)
    k, r = divmod(elems, m)
    dst[:, :k * m].view(n, k, m).copy_(fl[:, :k])
    if r:
        dst[:, k * m:].copy_(fl[:, k, :r])
    return comm.unlocal(out)


def tree_all_reduce(x: torch.Tensor, rs_prog: PermuteProgram,
                    ag_prog: PermuteProgram, comm, *,
                    accum_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Bandwidth-optimal allreduce: reduce-scatter then allgather.
    Matches `lax.psum` semantics for arbitrary-shaped x."""
    flat, elems = _split_ranks(x, rs_prog.axis_size, comm)
    shard = tree_reduce_scatter(flat, rs_prog, comm,
                                accum_dtype=accum_dtype)
    del flat
    full = tree_all_gather(shard, ag_prog, comm)
    return _join_ranks(full, x, elems, comm)


# ---------------------------------------------------------------------- #
# multi-axis composition (hierarchical: RS in, AG out)
# ---------------------------------------------------------------------- #

def tree_all_reduce_multi(x: torch.Tensor, progs: Sequence[tuple], *,
                          accum_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Allreduce over several mesh axes: reduce-scatter innermost-out, then
    allgather in reverse — the standard hierarchical composition, with each
    stage's schedule bandwidth-optimal for its own axis topology.

    progs: sequence of (comm, rs_prog, ag_prog), one per axis.  With
    `P2P` comms over each axis's process group; a `Stacked` comm holds one
    axis only, so it serves a single-axis sequence."""
    if not progs:
        return x
    (comm, rs_p, ag_p), *rest = progs
    flat, elems = _split_ranks(x, rs_p.axis_size, comm)
    shard = tree_reduce_scatter(flat, rs_p, comm, accum_dtype=accum_dtype)
    shard = tree_all_reduce_multi(shard, rest, accum_dtype=accum_dtype)
    full = tree_all_gather(shard, ag_p, comm)
    return _join_ranks(full, x, elems, comm)
