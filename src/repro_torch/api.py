"""The port's front door to the schedule compiler: `Collectives`.

The schedule level of src/repro/api.py, over the port's copy of the compiler
(`repro_torch.core`, `repro_torch.topo`)::

    from repro_torch.api import Collectives

    coll = Collectives()
    sched = coll.schedule("torus2d:8x8", kind="allgather", num_chunks=16)
    ag, rs = coll.pair("bring:8")
    rs_prog, ag_prog = coll.program("dgx:8", kind="allreduce")
    fn = coll.executable("bring:8", kind="allreduce", comm=Stacked(8))

Topology arguments accept a `DiGraph`, a `repro_torch.topo.TopologySpec`, a
zoo row name or a raw spec string, as in the reference.  With a cache
attached (``Collectives(cache="/tmp/schedules")``, a path or a ready
`repro_torch.cache.ScheduleCache`) every method is replay-first and misses
compile and persist; `repair` delta-recompiles an artifact for a degraded
fabric, and with a cache replays a stored repair.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from repro_torch.core import plan as plan_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.graph import DiGraph
from repro_torch.core.schedule import AllReduceSchedule, PipelineSchedule
from repro_torch.topo.spec import SpecLike, resolve_topology

Artifact = Union[PipelineSchedule, AllReduceSchedule]

#: collective kinds the compiler understands
KINDS = ("allgather", "reduce_scatter", "broadcast", "reduce", "allreduce",
         "alltoall")
ROOTED_KINDS = ("broadcast", "reduce")
#: the default `family()` pair — what an allreduce consumer needs
PAIR_KINDS = ("allgather", "reduce_scatter")


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Declarative compile request: everything a schedule acquisition needs
    besides the topology itself.

    ``root=None`` on a rooted kind defaults to the smallest compute node at
    resolve time, so ``broadcast`` works out of the box; ``verify`` replays
    every chunk at compile time."""
    kind: str = "allgather"
    root: Optional[int] = None
    num_chunks: int = 8
    fixed_k: Optional[int] = None
    verify: bool = False

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.kind in ROOTED_KINDS and self.fixed_k is not None:
            raise ValueError(f"{self.kind} has no fixed-k variant "
                             f"(k = λ(root))")

    def replace(self, **overrides: Any) -> "CompileOptions":
        return dataclasses.replace(self, **overrides)

    def resolved_root(self, g: DiGraph) -> Optional[int]:
        if self.kind not in ROOTED_KINDS:
            return None
        return self.root if self.root is not None else min(g.compute)


class Collectives:
    """Facade owning the schedule cache and the staged compiler pipeline.

    ``cache`` is ``None`` (always compile), a directory path (an on-disk
    `repro_torch.cache.ScheduleCache` is created there, inheriting
    ``verify`` as its compile-time verification flag), or a ready
    `ScheduleCache`.  Remaining keywords set the default `CompileOptions`
    that per-call keywords override."""

    def __init__(self, cache: Any = None, *,
                 options: Optional[CompileOptions] = None,
                 **defaults: Any):
        if options is not None and defaults:
            raise TypeError("pass either options= or default keywords, "
                            "not both")
        self.options = options if options is not None \
            else CompileOptions(**defaults)
        self.cache = self._resolve_cache(cache, self.options.verify)

    @staticmethod
    def _resolve_cache(cache: Any, verify: bool):
        if cache is None or cache == "":
            return None
        if isinstance(cache, (str, bytes)) or hasattr(cache, "__fspath__"):
            from repro_torch.cache.store import ScheduleCache
            return ScheduleCache(cache, verify_on_compile=verify)
        return cache        # a ready ScheduleCache (or test double)

    # -------------------------------------------------------------- #
    # request plumbing
    # -------------------------------------------------------------- #

    def topology(self, topo: SpecLike) -> DiGraph:
        """Resolve any accepted topology form to a `DiGraph`."""
        return resolve_topology(topo)

    def opts(self, opts: Optional[CompileOptions] = None,
             **overrides: Any) -> CompileOptions:
        """Merge per-call overrides onto the facade defaults."""
        base = opts if opts is not None else self.options
        return base.replace(**overrides) if overrides else base

    @contextlib.contextmanager
    def _verify_on_compile(self, verify: bool):
        """Honor a per-call ``verify=True`` on the cache's miss path (hits
        replay an already-verified artifact).  Raising the flag only: a
        cache constructed with ``verify=True`` keeps verifying."""
        cache = self.cache
        if not verify or getattr(cache, "verify_on_compile", False):
            yield
            return
        cache.verify_on_compile = True
        try:
            yield
        finally:
            cache.verify_on_compile = False

    # -------------------------------------------------------------- #
    # schedules
    # -------------------------------------------------------------- #

    def schedule(self, topo: SpecLike,
                 opts: Optional[CompileOptions] = None,
                 **overrides: Any) -> Artifact:
        """One compiled artifact (`PipelineSchedule`, or
        `AllReduceSchedule` for ``kind="allreduce"``), cache-first."""
        g = self.topology(topo)
        o = self.opts(opts, **overrides)
        root = o.resolved_root(g)
        if self.cache is not None:
            with self._verify_on_compile(o.verify):
                if o.kind in ROOTED_KINDS:
                    return getattr(self.cache, o.kind)(
                        g, root=root, num_chunks=o.num_chunks)
                return getattr(self.cache, o.kind)(
                    g, num_chunks=o.num_chunks, fixed_k=o.fixed_k)
        if o.kind in ROOTED_KINDS:
            return getattr(schedule_mod, f"compile_{o.kind}")(
                g, root=root, num_chunks=o.num_chunks, verify=o.verify)
        return getattr(schedule_mod, f"compile_{o.kind}")(
            g, num_chunks=o.num_chunks, fixed_k=o.fixed_k, verify=o.verify)

    def family(self, topo: SpecLike,
               kinds: Sequence[str] = PAIR_KINDS,
               opts: Optional[CompileOptions] = None,
               timings: Optional[Dict[str, float]] = None,
               packed_out: Optional[Dict[str, Any]] = None,
               jobs: int = 1,
               **overrides: Any) -> Dict[str, Artifact]:
        """One topology's collective family compiled together — the §2.1
        solve and the split/pack products shared across kinds, byte-identical
        to per-kind compiles (`ScheduleCache.family` on the cache path).
        ``timings`` receives per-kind marginal wall seconds; ``packed_out``
        (fresh compiles only) the pre-rounds plans for P >= depth
        re-rounding; ``jobs > 1`` packs the independent orientations/kinds
        in worker processes (fresh-compile path only)."""
        g = self.topology(topo)
        o = self.opts(opts, **overrides)
        root = (o.replace(kind="broadcast").resolved_root(g)
                if any(k in ROOTED_KINDS for k in kinds) else None)
        if self.cache is not None:
            with self._verify_on_compile(o.verify):
                return self.cache.family(g, kinds, num_chunks=o.num_chunks,
                                         fixed_k=o.fixed_k, root=root,
                                         timings=timings)
        return plan_mod.compile_family(
            g, kinds=kinds, num_chunks=o.num_chunks, root=root,
            fixed_k=o.fixed_k, verify=o.verify, timings=timings,
            packed_out=packed_out, jobs=jobs)

    def pair(self, topo: SpecLike,
             opts: Optional[CompileOptions] = None,
             **overrides: Any) -> Tuple[PipelineSchedule, PipelineSchedule]:
        """(allgather, reduce_scatter) compiled as one family."""
        fam = self.family(topo, PAIR_KINDS, opts, **overrides)
        return fam["allgather"], fam["reduce_scatter"]

    # -------------------------------------------------------------- #
    # online repair
    # -------------------------------------------------------------- #

    def repair(self, artifact: Union[Artifact, SpecLike], transform,
               opts: Optional[CompileOptions] = None, *,
               use_cache: bool = True, verify: bool = True,
               **overrides: Any) -> Tuple[Artifact, Any]:
        """Delta-recompile a compiled artifact for a degraded topology.

        ``artifact`` is a compiled `PipelineSchedule` / `AllReduceSchedule`
        (its warm oracle state may still be resident), or any topology form,
        whose base schedule is acquired first with `schedule()`.
        ``transform`` is a `repro_torch.topo.spec.TransformSpec` or its text
        (``"@fail(0-1)"``, ``"@degrade(2-3,cap=1)"``).

        Returns ``(repaired_artifact, RepairReport)``: the artifact is
        byte-identical to a cold compile of the transformed topology and,
        with ``verify=True``, replayed chunk by chunk on it.  With a cache,
        the result is stored under its degraded-topology key plus a
        transform-keyed ``.repair`` sidecar, so the same (base, transform)
        repair replays without compiling: the replayed report carries
        ``cached=True`` and the original repair wall time.  Fixed-k and
        alltoall artifacts raise `RepairError`."""
        from repro_torch.core.repair import (RepairError, RepairReport,
                                             repair_artifact)
        from repro_torch.topo.spec import TransformSpec
        spec = (transform if isinstance(transform, TransformSpec)
                else TransformSpec.parse_text(transform))
        o = self.opts(opts, **overrides)
        if o.fixed_k is not None:
            raise RepairError(
                "repair requires automatic k: the §2.4 fixed-k floor is "
                "not recorded on artifacts and its floor-scaled capacities "
                "do not delta-compose — recompile the degraded topology "
                "cold instead")
        if (getattr(artifact, "kind", None) == "alltoall"
                or (not isinstance(artifact,
                                   (PipelineSchedule, AllReduceSchedule))
                    and o.kind == "alltoall")):
            raise RepairError(
                "repair does not support alltoall artifacts (the merged "
                "per-source scatter rounds are rebuilt whole-cloth from "
                "the packing) — recompile the degraded topology instead")
        if not isinstance(artifact, (PipelineSchedule, AllReduceSchedule)):
            artifact = self.schedule(artifact, opts, **overrides)
        if self.cache is not None and use_cache:
            hit = self.cache.repaired(artifact, spec)
            if hit is not None:
                art, meta = hit
                report = RepairReport.from_dict(meta["report"])
                report.cached = True
                return art, report
        repaired, report = repair_artifact(artifact, spec, verify=verify)
        if self.cache is not None and use_cache:
            self.cache.put_repaired(artifact, spec, repaired, report)
        return repaired, report

    # -------------------------------------------------------------- #
    # lowered programs / executables
    # -------------------------------------------------------------- #

    def lower(self, artifact: Artifact):
        """Stage-5 lowering of a compiled artifact to static permute
        program(s); an `AllReduceSchedule` lowers to ``(rs_prog, ag_prog)``
        — the argument order `tree_all_reduce` expects."""
        from repro_torch.comms.executor import compile_program
        if isinstance(artifact, AllReduceSchedule):
            return compile_program(artifact.rs), compile_program(artifact.ag)
        return compile_program(artifact)

    def program(self, topo: SpecLike,
                opts: Optional[CompileOptions] = None, **overrides: Any):
        """Schedule + lower in one step.  ``kind="allreduce"`` returns
        ``(rs_prog, ag_prog)``; every other kind one `PermuteProgram`."""
        return self.lower(self.schedule(topo, opts, **overrides))

    def executable(self, topo: SpecLike, *, comm,
                   opts: Optional[CompileOptions] = None,
                   **overrides: Any) -> Callable:
        """A ready-to-call collective over ``comm`` (a
        `repro_torch.comms.P2P` process group or a `Stacked` axis): the
        schedule is compiled, lowered, and bound to the matching
        `repro_torch.comms.collectives.tree_*` executor.  Extra keyword
        arguments of the ``tree_*`` function (e.g. ``accum_dtype``) pass
        through the returned callable."""
        o = self.opts(opts, **overrides)
        from repro_torch.comms import collectives as tree_mod
        if o.kind == "allreduce":
            rs_prog, ag_prog = self.program(topo, o)

            def run_allreduce(x, **kw):
                return tree_mod.tree_all_reduce(x, rs_prog, ag_prog, comm,
                                                **kw)
            return run_allreduce
        prog = self.program(topo, o)
        fn = {
            "allgather": tree_mod.tree_all_gather,
            "reduce_scatter": tree_mod.tree_reduce_scatter,
            "broadcast": tree_mod.tree_broadcast,
            "reduce": tree_mod.tree_reduce,
            "alltoall": tree_mod.tree_all_to_all,
        }[o.kind]

        def run(x, **kw):
            return fn(x, prog, comm, **kw)
        return run

    # -------------------------------------------------------------- #
    # introspection
    # -------------------------------------------------------------- #

    def describe(self) -> str:
        cache = self.cache.describe() if self.cache is not None else "none"
        return f"Collectives[{self.options}] cache={cache}"
