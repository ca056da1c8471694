"""Per-mesh-axis schedule compilation, caching and online repair.
Counterpart of src/repro/comms/mesh_axes.py.

Each mesh axis has a physical topology model and gets its own
bandwidth-optimal schedule through the port's `Collectives` facade.
Topologies default to the reference's model (`axis_topology_for_mesh`: a
bidirectional ring for a data axis) and can be overridden per axis with any
spec form — ``CollectiveContext({'data': 8}, topologies={'data': 'dgx:8'})``.
Programs are kept per (axis, kind) in memory; a facade with an on-disk
`repro_torch.cache.ScheduleCache` also skips compilation across launches.
`hot_swap` repairs every program of the axes a link fault touches.  The
broadcast and alltoall programs run through `tree_broadcast` and
`tree_all_to_all` (the latter carries expert-parallel MoE dispatch,
`repro_torch.models.moe.moe_forward_alltoall`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
    compiles, and caches when it owns a cache (by default one with P =
    `num_chunks`, no cache)."""

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
        self._broadcast: Dict[Tuple[str, int], PermuteProgram] = {}
        self._broadcast_scheds: Dict[Tuple[str, int], PipelineSchedule] = {}
        self._alltoall: Dict[str, PermuteProgram] = {}
        self._alltoall_scheds: Dict[str, PipelineSchedule] = {}

    @property
    def schedule_cache(self):
        """The facade's attached `ScheduleCache` (None when uncached)."""
        return self.collectives.cache

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

    def broadcast_program(self, axis: str, root: int = 0) -> PermuteProgram:
        """Single-root broadcast program for `axis`, cache-backed like every
        other kind and memoized per (axis, root)."""
        key = (axis, root)
        if key not in self._broadcast:
            sched = self.collectives.schedule(
                self.topology(axis), kind="broadcast", root=root)
            self._broadcast_scheds[key] = sched
            self._broadcast[key] = self.collectives.lower(sched)
        return self._broadcast[key]

    def alltoall_program(self, axis: str) -> PermuteProgram:
        """All-to-all program for `axis`, compiled at P = 1 as in the
        reference (each tree already pipelines its A-1 destination
        blocks), cache-backed and memoized per axis."""
        if axis not in self._alltoall:
            sched = self.collectives.schedule(
                self.topology(axis), kind="alltoall", num_chunks=1)
            self._alltoall_scheds[axis] = sched
            self._alltoall[axis] = self.collectives.lower(sched)
        return self._alltoall[axis]

    def hot_swap(self, transform, axes: Optional[Sequence[str]] = None
                 ) -> Dict[str, List]:
        """Repair every compiled schedule of the axes a link fault touches,
        and swap the repaired programs in at once.

        ``transform`` is a `repro_torch.topo.spec.TransformSpec` or its text
        (``"@fail(0-1)"``, ``"@degrade(2-3,cap=1)"``); axes whose topology
        lacks the link are left untouched.  Every memoized artifact of an
        affected axis (AG/RS pair, allreduce, broadcasts) is delta-recompiled
        through `Collectives.repair`, byte-identical to a cold compile of the
        degraded topology and verified on it, and re-lowered; the axis
        topology becomes the degraded one, so later compiles see it.  All
        repairs are staged first and committed in one pass, so a failing
        repair (a fault that disconnects an axis) raises with the context
        unchanged; an affected axis holding an alltoall program raises
        `RepairError` before anything is repaired.  A `BucketedAllReduce`
        built before the swap keeps the programs it was built from: build
        the hook again after a swap.  Returns ``{axis: [RepairReport]}``."""
        from repro_torch.topo.spec import TransformSpec
        spec = (transform if isinstance(transform, TransformSpec)
                else TransformSpec.parse_text(transform))
        if len(spec.args) < 2:
            raise ValueError(f"{spec} names no link; hot_swap repairs "
                             f"link-level faults")
        u, v = spec.args[0], spec.args[1]
        scope = (list(axes) if axes is not None
                 else [a for a, n in self.mesh_axes.items() if n > 1])
        reports: Dict[str, List] = {}
        staged_topo: Dict[str, DiGraph] = {}
        staged_axis: Dict[str, AxisSchedules] = {}
        staged_ar: Dict[str, object] = {}
        staged_bc: Dict[Tuple[str, int], tuple] = {}
        for a in scope:
            topo = self.topology(a)
            if (u, v) not in topo.cap and (v, u) not in topo.cap:
                continue        # the fault is not on this axis's fabric
            if a in self._alltoall_scheds:
                from repro_torch.core.repair import RepairError
                raise RepairError(
                    f"axis {a!r} holds a compiled alltoall program and "
                    f"repair does not support alltoall — rebuild the "
                    f"context against the degraded fabric instead (nothing "
                    f"was swapped)")
            axis_reports = []
            degraded: Optional[DiGraph] = None
            if a in self._cache:
                ax = self._cache[a]
                ag2, rep_ag = self.collectives.repair(ax.ag_sched, spec)
                rs2, rep_rs = self.collectives.repair(ax.rs_sched, spec)
                axis_reports += [rep_ag, rep_rs]
                degraded = ag2.topo
                staged_axis[a] = AxisSchedules(
                    axis_name=a, topology=ag2.topo,
                    ag_sched=ag2, rs_sched=rs2,
                    ag_prog=self.collectives.lower(ag2),
                    rs_prog=self.collectives.lower(rs2))
            if a in self._allreduce:
                ar2, rep = self.collectives.repair(self._allreduce[a], spec)
                axis_reports.append(rep)
                degraded = ar2.topo
                staged_ar[a] = ar2
            for (ax_name, root), sched in self._broadcast_scheds.items():
                if ax_name != a:
                    continue
                b2, rep = self.collectives.repair(sched, spec)
                axis_reports.append(rep)
                degraded = b2.topo
                staged_bc[(ax_name, root)] = (b2, self.collectives.lower(b2))
            if degraded is None:        # nothing compiled yet on this axis
                degraded = spec.apply(topo)
            staged_topo[a] = degraded
            reports[a] = axis_reports
        if not reports:
            raise ValueError(f"{spec} applies to no axis of this mesh "
                             f"(axes {scope})")
        # commit: nothing above touched live state, so a failed repair
        # leaves every program as it was
        self._topologies.update(staged_topo)
        self._cache.update(staged_axis)
        self._allreduce.update(staged_ar)
        for key, (sched, prog) in staged_bc.items():
            self._broadcast_scheds[key] = sched
            self._broadcast[key] = prog
        return reports

    def compile_stats_report(self) -> str:
        """Per-stage schedule-compiler wall times of every artifact this
        context holds (a cache hit reports the stage times of the original
        compilation, replayed from the stats sidecar)."""
        lines = ["schedule compile stages (solve|split|pack|rounds|lower):"]

        def add(tag: str, sched) -> None:
            cs = getattr(sched, "compile_stats", None)
            if cs is not None:
                lines.append(f"  {tag}: {cs.describe()}")

        for a, ax in self._cache.items():
            add(f"{a}", ax.ag_sched)
            add(f"{a}", ax.rs_sched)
        for a, ar in self._allreduce.items():
            add(f"{a}.allreduce", ar.rs)
            add(f"{a}.allreduce", ar.ag)
        for (a, root), sched in self._broadcast_scheds.items():
            add(f"{a}.r{root}", sched)
        for a, sched in self._alltoall_scheds.items():
            add(f"{a}.alltoall", sched)
        if len(lines) == 1:
            return "schedule compile stages: (nothing compiled yet)"
        return "\n".join(lines)

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
