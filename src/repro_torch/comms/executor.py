"""Compile a `PipelineSchedule` into a static CollectivePermute program.

On TPU the native point-to-point collective is CollectivePermute
(`jax.lax.ppermute`): one call moves, for every (src, dst) pair in a partial
permutation, the src's operand buffer to dst.  A pipeline round — a set of
simultaneous chunk transfers — therefore becomes one or more ppermute calls:

* sends in a round are grouped by (src, dst) and laid out in slot order;
* each "layer" (i-th chunk of every pair) is decomposed into partial
  permutations (JAX requires unique sources AND destinations per call; tree
  fan-out of degree d costs d calls — same bytes, the per-link load already
  accounts for it);
* calls with identical permutations across consecutive layers are merged
  into one width-w call moving a [w, chunk] stacked payload (this collapses
  the m parallel trees of a multiplicity-m class into a single call).

The result is a `PermuteProgram`: a static, SPMD-safe artifact.  Every
device executes the same call sequence; per-device behaviour is driven by
gather/scatter index tables indexed with `lax.axis_index` inside shard_map.
Slot index `num_slots` is a trash row: devices that do not receive in a call
scatter the (zero) ppermute result there.

Copied from src/repro/comms/executor.py so that the port lowers exactly the
same programs.  The port runs them with `repro_torch.comms.collectives`: one
`PermuteCall` becomes a `torch.distributed` P2P group, or an index over the
rank dimension when all ranks of an axis are stacked on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.schedule import PipelineSchedule, Send


@dataclasses.dataclass(frozen=True)
class PermuteCall:
    """One ppermute: a partial permutation moving `width` stacked chunks."""
    perm: Tuple[Tuple[int, int], ...]           # (src, dst) pairs
    send_slots: np.ndarray                      # [axis_size, width] int32
    recv_slots: np.ndarray                      # [axis_size, width] int32
    width: int


@dataclasses.dataclass(frozen=True)
class PermuteProgram:
    kind: str
    axis_size: int                 # number of devices in the group
    num_slots: int                 # N * slots_per_shard (+1 trash row extra)
    slots_per_shard: int           # k * P
    rounds: Tuple[Tuple[PermuteCall, ...], ...]
    root: Optional[int] = None     # single root (broadcast/reduce kinds)

    @property
    def num_calls(self) -> int:
        return sum(len(r) for r in self.rounds)

    def describe(self) -> str:
        return (f"PermuteProgram[{self.kind}] A={self.axis_size} "
                f"S={self.slots_per_shard} rounds={len(self.rounds)} "
                f"calls={self.num_calls}")


def _slot_of(send: Send, slots_per_shard: int) -> int:
    return send.root * slots_per_shard + send.slot


def compile_program(sched: PipelineSchedule) -> PermuteProgram:
    """Lower a pipeline schedule to ppermute calls (device ids = compute
    node ids, which the topology constructors number 0..A-1).

    This is stage 5 ("lower") of the staged compiler pipeline: its wall
    time is recorded into the schedule's `compile_stats` (replacing any
    earlier lower record, so repeated lowering stays idempotent)."""
    t0 = time.perf_counter()
    a = sched.num_nodes
    s = sched.slots_per_shard
    if sorted(sched.dstar.compute) != list(range(a)):
        raise ValueError("compute node ids must be 0..A-1 for execution")
    trash = a * s
    rounds: List[Tuple[PermuteCall, ...]] = []
    for rnd in sched.rounds:
        # (src, dst) -> ordered slot list
        pair_slots: Dict[Tuple[int, int], List[int]] = {}
        for send in sorted(rnd, key=lambda x: (x.cls, x.slot)):
            pair_slots.setdefault((send.src, send.dst), []).append(
                _slot_of(send, s))
        # layer l = l-th slot of each pair; then partial-permutation split
        max_layers = max(len(v) for v in pair_slots.values())
        raw_calls: List[Dict[Tuple[int, int], int]] = []
        for layer in range(max_layers):
            todo = {p: sl[layer] for p, sl in pair_slots.items()
                    if len(sl) > layer}
            while todo:
                call: Dict[Tuple[int, int], int] = {}
                used_src, used_dst = set(), set()
                for (src, dst), slot in sorted(todo.items()):
                    if src in used_src or dst in used_dst:
                        continue
                    call[(src, dst)] = slot
                    used_src.add(src)
                    used_dst.add(dst)
                for p in call:
                    del todo[p]
                raw_calls.append(call)
        # merge consecutive calls with identical perms into width-w calls
        merged: List[List[Dict[Tuple[int, int], int]]] = []
        for call in raw_calls:
            if merged and set(merged[-1][0]) == set(call):
                merged[-1].append(call)
            else:
                merged.append([call])
        calls: List[PermuteCall] = []
        for group in merged:
            w = len(group)
            perm = tuple(sorted(group[0]))
            send_slots = np.zeros((a, w), dtype=np.int32)
            recv_slots = np.full((a, w), trash, dtype=np.int32)
            for j, call in enumerate(group):
                for (src, dst), slot in call.items():
                    send_slots[src, j] = slot
                    recv_slots[dst, j] = slot
            calls.append(PermuteCall(perm=perm, send_slots=send_slots,
                                     recv_slots=recv_slots, width=w))
        rounds.append(tuple(calls))
    prog = PermuteProgram(kind=sched.kind, axis_size=a,
                          num_slots=a * s, slots_per_shard=s,
                          rounds=tuple(rounds), root=sched.root)
    stats = getattr(sched, "compile_stats", None)
    if stats is not None:
        sched.compile_stats = stats.with_stage(
            "lower", time.perf_counter() - t0,
            calls=prog.num_calls, rounds=len(prog.rounds))
    return prog
