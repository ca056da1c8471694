"""§2.1 Optimality binary search.

Computes the exact rational value of the allgather lower bound

    1/x* = max_{S ⊂ V, S ⊉ Vc} |S ∩ Vc| / B+_G(S)          (paper eq. 1)

using the Theorem-1 maxflow oracle inside a binary search, then recovers the
exact fraction via Proposition 2 (denominator bound) + the continued-fraction
"simplest fraction in an interval" routine.  Proposition 3 then yields the
minimal tree multiplicity k and capacity multiplier U with U/k = 1/x*.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from fractions import Fraction
from typing import Optional, Tuple

from .graph import DiGraph, validate_eulerian
from .maxflow import SourcedNetwork


# ---------------------------------------------------------------------- #
# Theorem 1 oracle
# ---------------------------------------------------------------------- #

def _oracle_net(g: DiGraph) -> SourcedNetwork:
    """The Theorem-1 D_k shape (super-source tied to every compute node),
    built once per search and re-scaled per probe.  The sink sweep adapts
    across probes (the network remembers the last failing sink and tries
    it first), so the infeasible half of the binary search usually fails
    after a single maxflow.  Flows stay cold per probe: a probe rescales
    *every* capacity by a new numerator, so there is no small delta for
    the warm-start engine to re-augment (unlike the §2.2 searches)."""
    return SourcedNetwork(g, {u: 0 for u in sorted(g.compute)})


def _feasible_on(net: SourcedNetwork, runtime: Fraction) -> bool:
    if runtime <= 0:
        return False
    p, q = runtime.numerator, runtime.denominator
    net.rescale_graph_caps(p)
    net.set_source_caps(q)
    threshold = net.g.num_compute * q
    return net.min_source_flow_at_least(sorted(net.g.compute), threshold)


def oracle_feasible(g: DiGraph, runtime: Fraction) -> bool:
    """True iff `runtime` >= 1/x*, i.e. min_v F(s, v; G_x) >= |Vc| x with
    x = 1/runtime (Theorem 1).  Implemented with integer-scaled capacities:
    runtime = p/q  =>  scale topology caps by p, source edges get cap q,
    threshold |Vc|*q."""
    return _feasible_on(_oracle_net(g), runtime)


def check_reachable(g: DiGraph) -> None:
    """Allgather requires every compute node reachable from every other."""
    for root in sorted(g.compute):
        seen = {root}
        stack = [root]
        adj: dict[int, list[int]] = {}
        for (u, v) in g.cap:
            adj.setdefault(u, []).append(v)
        while stack:
            u = stack.pop()
            for v in adj.get(u, ()):  # capacities are positive by invariant
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        missing = g.compute - seen
        if missing:
            raise ValueError(
                f"{g.name}: compute node(s) {sorted(missing)} unreachable "
                f"from {root}; allgather impossible")


# ---------------------------------------------------------------------- #
# Simplest fraction in a closed interval (continued fractions)
# ---------------------------------------------------------------------- #

def simplest_between(lo: Fraction, hi: Fraction) -> Fraction:
    """The fraction with the smallest denominator in [lo, hi] (ties: smallest
    numerator).  Standard Stern–Brocot / continued-fraction descent."""
    if lo > hi:
        raise ValueError(f"empty interval [{lo}, {hi}]")
    if lo == hi:
        return lo
    if lo <= 0 <= hi:
        return Fraction(0)
    if hi < 0:
        return -simplest_between(-hi, -lo)
    # now 0 < lo < hi
    fl = lo.numerator // lo.denominator  # floor(lo)
    if Fraction(fl) >= lo:
        return Fraction(fl)
    if Fraction(fl + 1) <= hi:
        return Fraction(fl + 1)
    inner = simplest_between(1 / (hi - fl), 1 / (lo - fl))
    return fl + 1 / inner


# ---------------------------------------------------------------------- #
# The binary search itself
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Optimality:
    """Result of the §2.1 search for topology G.

    inv_x_star : 1/x* — optimal bandwidth runtime in units of (M/N)/bandwidth
    U          : capacity multiplier (Prop 3); G({U b_e}) has integer caps
    k          : number of spanning trees per compute-node root (minimal)
    """
    inv_x_star: Fraction
    U: Fraction
    k: int

    @property
    def runtime_factor(self) -> Fraction:
        """T_B = (M/N) * runtime_factor (bandwidth units)."""
        return self.inv_x_star


def allgather_inv_xstar(g: DiGraph,
                        net: Optional[SourcedNetwork] = None) -> Fraction:
    """Binary search of §2.1; returns exact rational 1/x*.

    `net` lets callers pass in (and afterwards retain) the Theorem-1
    oracle network — `repro.core.repair` keeps it warm for later
    delta-recompiles of the same topology.  It must be bound to `g`."""
    check_reachable(g)
    n = g.num_compute
    if n == 1:
        return Fraction(0)
    dmin = g.min_compute_ingress()
    if dmin <= 0:
        raise ValueError(f"{g.name}: a compute node has zero ingress")
    lo = Fraction(n - 1, dmin)
    hi = Fraction(n - 1)
    if net is None:
        net = _oracle_net(g)      # one network serves every probe below
    assert net.g is g, "oracle network bound to a different graph"
    if _feasible_on(net, lo):
        return lo
    # invariant: lo infeasible (< 1/x*), hi feasible (>= 1/x*)
    gap = Fraction(1, dmin * dmin)
    while hi - lo > gap:
        mid = (lo + hi) / 2
        if _feasible_on(net, mid):
            hi = mid
        else:
            lo = mid
    # 1/x* is the unique fraction with denominator <= dmin in [lo, hi]
    # (Proposition 2); `simplest_between` finds it.
    cand = simplest_between(lo, hi)
    assert cand.denominator <= dmin, (cand, dmin)
    assert _feasible_on(net, cand), f"recovered {cand} not feasible"
    return cand


def choose_U_k(g: DiGraph, inv_x_star: Fraction) -> Tuple[Fraction, int]:
    """Proposition 3: minimal k with U/k = 1/x* and U*b_e integral."""
    if inv_x_star == 0:  # single compute node: no communication
        return Fraction(0), 1
    p, q = inv_x_star.numerator, inv_x_star.denominator
    gcd_b = g.bandwidth_gcd()
    gden = math.gcd(q, gcd_b)
    U = Fraction(p, gden)
    k = q // gden
    assert U / k == inv_x_star
    return U, k


def solve_optimality(g: DiGraph,
                     net: Optional[SourcedNetwork] = None) -> Optimality:
    """Full §2.1: exact 1/x*, then minimal (U, k)."""
    validate_eulerian(g)
    inv = allgather_inv_xstar(g, net=net)
    U, k = choose_U_k(g, inv)
    return Optimality(inv_x_star=inv, U=U, k=k)


# ---------------------------------------------------------------------- #
# Brute-force reference (exponential; used by tests on small graphs)
# ---------------------------------------------------------------------- #

def brute_force_inv_xstar(g: DiGraph) -> Fraction:
    """Enumerate every cut S ⊂ V with S ⊉ Vc — O(2^|V|), tests only."""
    best = Fraction(0)
    nodes = list(range(g.num_nodes))
    for r in range(1, g.num_nodes + 1):
        for s in itertools.combinations(nodes, r):
            ss = set(s)
            if g.compute <= ss:
                continue
            nc = len(ss & g.compute)
            if nc == 0:
                continue
            out = g.egress_set(ss)
            if out == 0:
                raise ValueError("disconnected cut; allgather impossible")
            best = max(best, Fraction(nc, out))
    return best
