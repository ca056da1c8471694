"""Content-addressed keys for schedule artifacts.  Counterpart of
src/repro/cache/fingerprint.py, with the same key layout and artifact
FORMAT_VERSION.

Two fingerprints combine into a cache key:

* ``graph_fingerprint`` — the topology side.  Canonical form = node count +
  compute set + switch set + sorted edge/capacity multiset (see
  `DiGraph.canonical_form`); the display name is excluded, so structurally
  identical topologies share entries.

* ``compiler_fingerprint`` — the code side.  A hash over the *source text*
  of every `repro_torch.core` module that participates in compilation plus
  the artifact `FORMAT_VERSION`.  The port hashes its own copy of the
  compiler, so its fingerprint differs from the reference's and the two
  packages' caches never share an entry.  Any edit to the optimality search, edge
  splitting, packing, round construction or the serialization schema
  changes the fingerprint and invalidates every cached schedule — stale
  artifacts are never replayed after a compiler change.
"""
from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Optional

from repro_torch.core.graph import DiGraph

# Bump when the JSON schema in serialize.py changes incompatibly.
# v2: schedule payloads carry an explicit `root` field (single-root
# broadcast/reduce kinds; null for allgather/reduce-scatter), and the kind
# vocabulary grew to {allgather, reduce_scatter, broadcast, reduce}.
# v3: the kind vocabulary grew `alltoall` (per-source scatter-tree
# schedules whose slots fold the destination in: slot = dest·k·P +
# subslot); the field layout is unchanged, but older readers would
# mis-simulate an alltoall payload, so the version gates them out.
FORMAT_VERSION = 3

# Modules whose behaviour determines what a compiled schedule looks like.
_COMPILER_MODULES = (
    "repro_torch.core.graph",
    "repro_torch.core.maxflow",
    "repro_torch.core.optimality",
    "repro_torch.core.edge_split",
    "repro_torch.core.arborescence",
    "repro_torch.core.fixed_k",
    "repro_torch.core.schedule",
    "repro_torch.core.plan",
    "repro_torch.core.repair",
    "repro_torch.core.simulate",
)


def graph_fingerprint(g: DiGraph) -> str:
    return g.fingerprint()


@lru_cache(maxsize=1)
def compiler_fingerprint() -> str:
    """Hex digest (16 chars) of the schedule compiler's source code."""
    import importlib

    h = hashlib.sha256()
    h.update(f"format={FORMAT_VERSION}".encode())
    for name in _COMPILER_MODULES:
        mod = importlib.import_module(name)
        path = getattr(mod, "__file__", None)
        h.update(name.encode())
        if path:
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def schedule_cache_key(kind: str, topo: DiGraph, num_chunks: int,
                       fixed_k: Optional[int] = None,
                       root: Optional[int] = None,
                       compiler_fp: Optional[str] = None) -> str:
    """Filename-safe key identifying one compiled artifact."""
    parts = [kind, topo.fingerprint(), f"p{num_chunks}",
             f"k{fixed_k if fixed_k is not None else 'auto'}"]
    if root is not None:
        parts.append(f"r{root}")
    parts.append(compiler_fp or compiler_fingerprint())
    return "-".join(parts)


def transform_slug(transform) -> str:
    """Filename-safe token for a `TransformSpec` — ``@degrade(0-8,cap=1)``
    becomes ``degrade.0-8.cap=1`` — stable across processes because
    `TransformSpec.__str__` is canonical (sorted kwargs)."""
    import re

    return re.sub(r"[^A-Za-z0-9.=_-]+", ".", str(transform).lstrip("@")).strip(".")


def repair_cache_key(kind: str, base_topo: DiGraph, transform,
                     num_chunks: int, fixed_k: Optional[int] = None,
                     root: Optional[int] = None,
                     compiler_fp: Optional[str] = None) -> str:
    """Key for the `.repair` sidecar of one repaired artifact.

    Keyed by the *base* (pre-fault) graph fingerprint plus the transform —
    not by the degraded graph — so an online repair path can look up "base
    artifact X under fault Y" without first building the degraded topology.
    The sidecar then points at the repaired artifact, which lives under its
    natural degraded-topology `schedule_cache_key`.
    """
    parts = ["repair", kind, base_topo.fingerprint(), transform_slug(transform),
             f"p{num_chunks}", f"k{fixed_k if fixed_k is not None else 'auto'}"]
    if root is not None:
        parts.append(f"r{root}")
    parts.append(compiler_fp or compiler_fingerprint())
    return "-".join(parts)
