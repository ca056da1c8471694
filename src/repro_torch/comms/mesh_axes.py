"""Per-mesh-axis schedule compilation.  Counterpart of
src/repro/comms/mesh_axes.py.

Each mesh axis has a physical topology model and gets its own
bandwidth-optimal schedule through the port's `Collectives` facade.
Topologies default to the reference's model (`axis_topology_for_mesh`: a
bidirectional ring for a data axis) and can be overridden per axis with any
spec form — ``CollectiveContext({'data': 8}, topologies={'data': 'dgx:8'})``.
Programs are kept per axis in memory.  Broadcast, alltoall and `hot_swap`
wait for later slices (ROADMAP.md queue A, items A2, A4, A6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.api import Collectives
from repro_torch.core.graph import DiGraph
from repro_torch.core.schedule import PipelineSchedule
from repro_torch.topo.spec import SpecLike, resolve_topology
from repro_torch.topo.tpu import axis_topology_for_mesh

from .executor import PermuteProgram


@dataclasses.dataclass
class AxisSchedules:
    axis_name: str
    topology: DiGraph
    ag_sched: PipelineSchedule
    rs_sched: PipelineSchedule
    ag_prog: PermuteProgram
    rs_prog: PermuteProgram


class CollectiveContext:
    """Holds compiled tree-pipeline programs for every axis of a mesh.

    mesh_axes: {axis_name: size}.  `collectives` is the facade that
    compiles (by default one with P = `num_chunks`)."""

    def __init__(self, mesh_axes: Dict[str, int],
                 num_chunks: Optional[int] = None,
                 topologies: Optional[Dict[str, SpecLike]] = None,
                 fixed_k: Optional[int] = None,
                 collectives: Optional[Collectives] = None):
        self.mesh_axes = dict(mesh_axes)
        if collectives is None:
            collectives = Collectives(
                num_chunks=num_chunks if num_chunks is not None else 8,
                fixed_k=fixed_k)
        elif num_chunks is not None or fixed_k is not None:
            raise TypeError("pass either collectives= or num_chunks=/"
                            "fixed_k=, not both — the facade already "
                            "carries them")
        self.collectives = collectives
        self.num_chunks = collectives.options.num_chunks
        self.fixed_k = collectives.options.fixed_k
        self._topologies: Dict[str, DiGraph] = {
            axis: resolve_topology(t)
            for axis, t in (topologies or {}).items()}
        self._cache: Dict[str, AxisSchedules] = {}
        self._allreduce: Dict[str, object] = {}

    def topology(self, axis: str) -> DiGraph:
        if axis not in self._topologies:
            self._topologies[axis] = axis_topology_for_mesh(
                axis, self.mesh_axes[axis])
        return self._topologies[axis]

    def axis(self, axis: str) -> AxisSchedules:
        """AG + RS schedules and programs for one axis, compiled as a
        single family: the §2.1 solve and the split/pack products are shared
        between the two orientations."""
        if axis not in self._cache:
            topo = self.topology(axis)
            ag, rs = self.collectives.pair(topo)
            self._cache[axis] = AxisSchedules(
                axis_name=axis, topology=topo, ag_sched=ag, rs_sched=rs,
                ag_prog=self.collectives.lower(ag),
                rs_prog=self.collectives.lower(rs))
        return self._cache[axis]

    def allreduce_schedule(self, axis: str):
        """The composed RS+AG `AllReduceSchedule` for one axis — the
        artifact `BucketedAllReduce` consumers run."""
        if axis not in self._allreduce:
            self._allreduce[axis] = self.collectives.schedule(
                self.topology(axis), kind="allreduce")
        return self._allreduce[axis]

    def bucketed_allreduce(self, axis: str, comm,
                           bucket_bytes: int = 64 << 20, **kwargs):
        """A `BucketedAllReduce` gradient hook for `axis` over `comm` (the
        axis's `P2P` group or a `Stacked` axis), lowered from the axis's
        allreduce artifact.  `wire_dtype` passes through (bf16 by
        default)."""
        from .overlap import BucketedAllReduce
        return BucketedAllReduce.from_schedule(
            self.allreduce_schedule(axis), comm,
            bucket_bytes=bucket_bytes, **kwargs)

    def describe(self) -> str:
        lines = [f"CollectiveContext P={self.num_chunks}"]
        for a, size in self.mesh_axes.items():
            if size == 1:
                lines.append(f"  axis {a}: trivial (size 1)")
                continue
            ax = self.axis(a)
            lines.append(
                f"  axis {a}: {ax.topology.name} "
                f"1/x*={ax.ag_sched.opt.inv_x_star} k={ax.ag_sched.k} "
                f"AG {ax.ag_prog.describe()} RS {ax.rs_prog.describe()}")
        return "\n".join(lines)
