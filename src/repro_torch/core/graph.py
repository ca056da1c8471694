"""Integer-capacity directed graph — the topology representation.

The paper models a network as a digraph ``G = (Vs ∪ Vc, E)`` where ``Vc`` are
compute nodes, ``Vs`` are switch nodes, and every directed edge carries an
integer capacity (think: number of unit-bandwidth multi-edges).  All of the
schedule compiler (optimality search, edge splitting, arborescence packing)
operates on this representation.

Conventions
-----------
* Nodes are integers ``0..num_nodes-1``.
* ``compute`` is the set of compute nodes; every other node is a switch.
* ``cap[(u, v)]`` is the integer capacity of directed edge ``(u, v)``.
  Absent key == no edge.  Self-loops are disallowed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from fractions import Fraction
from typing import Dict, FrozenSet, Iterable, Iterator, List, Mapping, Tuple

Edge = Tuple[int, int]


@dataclasses.dataclass
class DiGraph:
    num_nodes: int
    compute: FrozenSet[int]
    cap: Dict[Edge, int]
    name: str = "G"

    # ------------------------------------------------------------------ #
    # construction / validation
    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        self.compute = frozenset(self.compute)
        self.cap = dict(self.cap)
        self.validate()

    def validate(self) -> None:
        if self.num_nodes <= 0:
            raise ValueError("graph must have at least one node")
        for u in self.compute:
            if not (0 <= u < self.num_nodes):
                raise ValueError(f"compute node {u} out of range")
        if not self.compute:
            raise ValueError("graph must have at least one compute node")
        for (u, v), c in self.cap.items():
            if u == v:
                raise ValueError(f"self-loop on node {u}")
            if not (0 <= u < self.num_nodes and 0 <= v < self.num_nodes):
                raise ValueError(f"edge ({u},{v}) out of range")
            if not isinstance(c, int) or c <= 0:
                raise ValueError(f"edge ({u},{v}) capacity must be positive int, got {c!r}")

    # ------------------------------------------------------------------ #
    # basic queries
    # ------------------------------------------------------------------ #
    @property
    def switches(self) -> FrozenSet[int]:
        return frozenset(range(self.num_nodes)) - self.compute

    @property
    def num_compute(self) -> int:
        return len(self.compute)

    def edges(self) -> Iterator[Tuple[Edge, int]]:
        return iter(self.cap.items())

    def out_edges(self, u: int) -> List[Tuple[int, int]]:
        """[(v, cap)] for every edge u -> v."""
        return [(v, c) for (a, v), c in self.cap.items() if a == u]

    def in_edges(self, u: int) -> List[Tuple[int, int]]:
        """[(v, cap)] for every edge v -> u."""
        return [(a, c) for (a, b), c in self.cap.items() if b == u]

    def egress(self, u: int) -> int:
        """Total egress capacity B+_G(u)."""
        return sum(c for (a, _), c in self.cap.items() if a == u)

    def ingress(self, u: int) -> int:
        """Total ingress capacity B-_G(u)."""
        return sum(c for (_, b), c in self.cap.items() if b == u)

    def egress_set(self, s: Iterable[int]) -> int:
        """Total capacity leaving the node set S, i.e. B+_G(S)."""
        ss = set(s)
        return sum(c for (u, v), c in self.cap.items() if u in ss and v not in ss)

    def ingress_set(self, s: Iterable[int]) -> int:
        ss = set(s)
        return sum(c for (u, v), c in self.cap.items() if u not in ss and v in ss)

    def is_eulerian(self) -> bool:
        """Every node has equal total ingress and egress capacity."""
        return all(self.egress(v) == self.ingress(v) for v in range(self.num_nodes))

    def min_compute_ingress(self) -> int:
        return min(self.ingress(v) for v in sorted(self.compute))

    def bandwidth_gcd(self) -> int:
        return math.gcd(*self.cap.values()) if self.cap else 1

    # ------------------------------------------------------------------ #
    # content addressing
    # ------------------------------------------------------------------ #
    def canonical_form(self) -> str:
        """Deterministic text encoding of the topology *structure*: node
        count, compute set, switch set and the sorted edge/capacity multiset.
        The display `name` is deliberately excluded so two differently-named
        builds of the same topology share one cache entry."""
        edges = ";".join(f"{u},{v},{c}" for (u, v), c in sorted(self.cap.items()))
        return (f"n={self.num_nodes}|c={','.join(map(str, sorted(self.compute)))}"
                f"|s={','.join(map(str, sorted(self.switches)))}|e={edges}")

    def fingerprint(self) -> str:
        """Content-addressed key for schedule caching (hex, 16 chars)."""
        return hashlib.sha256(self.canonical_form().encode()).hexdigest()[:16]

    # ------------------------------------------------------------------ #
    # transforms
    # ------------------------------------------------------------------ #
    def copy(self, name: str | None = None) -> "DiGraph":
        return DiGraph(self.num_nodes, self.compute, dict(self.cap),
                       name or self.name)

    def transpose(self) -> "DiGraph":
        """Reverse every edge (used for reduce-scatter = reversed allgather)."""
        return DiGraph(self.num_nodes, self.compute,
                       {(v, u): c for (u, v), c in self.cap.items()},
                       self.name + "^T")

    def scaled(self, factor: Fraction | int) -> "DiGraph":
        """Return G({factor * b_e}); every scaled capacity must be integral."""
        factor = Fraction(factor)
        new_cap: Dict[Edge, int] = {}
        for e, c in self.cap.items():
            scaled = factor * c
            if scaled.denominator != 1:
                raise ValueError(
                    f"capacity {c} * {factor} is not integral on edge {e}")
            if scaled > 0:
                new_cap[e] = int(scaled)
        return DiGraph(self.num_nodes, self.compute, new_cap,
                       f"{self.name}*{factor}")

    def floor_scaled(self, factor: Fraction | int) -> "DiGraph":
        """Return G({floor(factor * b_e)}) — used by fixed-k optimality (§2.4)."""
        factor = Fraction(factor)
        new_cap: Dict[Edge, int] = {}
        for e, c in self.cap.items():
            scaled = int(factor * c)  # floor for positive values
            if scaled > 0:
                new_cap[e] = scaled
        return DiGraph(self.num_nodes, self.compute, new_cap,
                       f"{self.name}*floor({factor})")

    def restricted_to(self, nodes: Iterable[int]) -> "DiGraph":
        """Induced subgraph on `nodes` (node ids are remapped to 0..len-1)."""
        order = sorted(set(nodes))
        remap = {v: i for i, v in enumerate(order)}
        cap = {(remap[u], remap[v]): c for (u, v), c in self.cap.items()
               if u in remap and v in remap}
        compute = frozenset(remap[v] for v in self.compute if v in remap)
        return DiGraph(len(order), compute, cap, self.name + "|sub")

    # ------------------------------------------------------------------ #
    # pretty printing
    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DiGraph({self.name!r}, n={self.num_nodes}, "
                f"compute={sorted(self.compute)}, edges={len(self.cap)})")

    def describe(self) -> str:
        lines = [f"{self.name}: {self.num_nodes} nodes "
                 f"({self.num_compute} compute, {len(self.switches)} switch), "
                 f"{len(self.cap)} edges"]
        for (u, v), c in sorted(self.cap.items()):
            lines.append(f"  {u} -> {v}  cap={c}")
        return "\n".join(lines)


def validate_eulerian(g: DiGraph) -> None:
    """Raise with a helpful message if g is not Eulerian (paper assumption b)."""
    bad = [(v, g.egress(v), g.ingress(v))
           for v in range(g.num_nodes) if g.egress(v) != g.ingress(v)]
    if bad:
        msg = ", ".join(f"node {v}: out={o} in={i}" for v, o, i in bad)
        raise ValueError(f"topology {g.name} is not Eulerian: {msg}")
