"""§2.4 Fixed-k optimality.

The minimal k from Proposition 3 can be as large as min_v B-(v)/gcd(b_e);
practical pipelines want few trees per root.  Theorems 13-15 let us binary
search the best achievable runtime (M/Nk)·U* for a *given* k, within
(M/Nk)/min_e b_e of the true optimum (Theorem 15).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

from .graph import DiGraph
from .maxflow import SourcedNetwork
from .optimality import simplest_between


def _fixed_k_net(g: DiGraph, k: int) -> SourcedNetwork:
    """One Theorem-14 oracle network per search; probes refloor every
    capacity (no warm-startable delta — see `optimality._oracle_net`), but
    the sink sweep adapts so infeasible probes fail on the first maxflow."""
    return SourcedNetwork(g, {u: k for u in sorted(g.compute)})


def _feasible_on(net: SourcedNetwork, k: int, U: Fraction) -> bool:
    net.floor_graph_caps(U)
    return net.min_source_flow_at_least(sorted(net.g.compute),
                                        net.g.num_compute * k)


def fixed_k_feasible(g: DiGraph, k: int, U: Fraction) -> bool:
    """Theorem 14 oracle: does G({⌊U b_e⌋}) pack k trees per root?
    (Theorem 5: min_v F(s, v; G_k(⌊U b_e⌋)) >= |Vc| k.)"""
    return _feasible_on(_fixed_k_net(g, k), k, U)


@dataclasses.dataclass(frozen=True)
class FixedKResult:
    k: int
    U_star: Fraction           # best (M/Nk)·U* runtime for this k
    runtime_factor: Fraction   # U*/k, in (M/N)/bandwidth units — compare 1/x*


def solve_fixed_k(g: DiGraph, k: int) -> FixedKResult:
    """Binary search of §2.4 for the exact rational U*."""
    n = g.num_compute
    if n == 1:
        return FixedKResult(k, Fraction(0), Fraction(0))
    dmin = g.min_compute_ingress()
    max_b = max(g.cap.values())
    lo = Fraction((n - 1) * k, dmin)
    hi = Fraction((n - 1) * k)
    net = _fixed_k_net(g, k)      # one network serves every probe below
    if _feasible_on(net, k, lo):
        return FixedKResult(k, lo, lo / k)
    gap = Fraction(1, max_b * max_b)
    while hi - lo > gap:
        mid = (lo + hi) / 2
        if _feasible_on(net, k, mid):
            hi = mid
        else:
            lo = mid
    cand = simplest_between(lo, hi)
    assert cand.denominator <= max_b, (cand, max_b)
    assert _feasible_on(net, k, cand), f"recovered U*={cand} infeasible"
    return FixedKResult(k, cand, cand / k)
