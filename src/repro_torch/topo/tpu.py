"""The TPU topology models of the reference, registered so that spec strings
resolve alike in both packages: the `v5e` pod torus, the `multipod` model,
and `axis_topology_for_mesh`, the default model of one mesh axis.

Copied from src/repro/topo/tpu.py without its `HardwareSpec` / `TPU_V5E`
roofline constants: those are a TPU's numbers; the card's are `H100_SXM` in
repro_torch/topo/hardware.py.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.graph import DiGraph, Edge

from .spec import register_topology


@register_topology("v5e", pattern="{rows}x{cols}")
def v5e_pod_topology(rows: int = 16, cols: int = 16,
                     cap: int = 1) -> DiGraph:
    """A v5e pod is a (wrapped) 2-D ICI torus; one capacity unit == one ICI
    link (~50 GB/s).  Direct-connect: §2.2 edge splitting is a no-op here."""
    from .zoo import torus_2d
    g = torus_2d(rows, cols, cap=cap)
    return DiGraph(g.num_nodes, g.compute, g.cap, f"v5e-{rows}x{cols}")


@register_topology("multipod", pattern="{num_pods}x{nodes_per_pod}")
def multipod_topology(num_pods: int = 2, nodes_per_pod: int = 4,
                      ici_cap: int = 10, dcn_cap: int = 1) -> DiGraph:
    """Pod-level multi-pod model: per-pod ICI modelled as a local switch with
    fat links (ici_cap per node), pods joined through a DCN switch with
    dcn_cap per node.  Structurally identical to the paper's Fig 1a — the
    cluster cut is the bottleneck, and edge splitting beats ring unwinding
    by ici_cap/... (4x in the paper's numbers).

    Node ids: compute 0..P*n-1, DCN switch = P*n, pod switches follow."""
    n = num_pods * nodes_per_pod
    dcn = n
    edges: Dict[Edge, int] = {}
    for p in range(num_pods):
        sw = n + 1 + p
        for i in range(nodes_per_pod):
            h = p * nodes_per_pod + i
            edges[(h, sw)] = ici_cap
            edges[(sw, h)] = ici_cap
    for h in range(n):
        edges[(h, dcn)] = dcn_cap
        edges[(dcn, h)] = dcn_cap
    return DiGraph(n + 1 + num_pods, frozenset(range(n)), edges,
                   f"multipod[{num_pods}x{nodes_per_pod},{ici_cap}/{dcn_cap}]")


def axis_topology_for_mesh(axis_name: str, axis_size: int) -> DiGraph:
    """Physical topology model for one mesh axis.

    On a 2-D ICI torus laid out as (data, model) = (16, 16), each mesh axis
    maps to torus rings: an axis of size A is a bidirectional ring of A chips
    (2 ICI links each way between neighbours along that axis are available
    to the axis' collectives — we model cap=1 per direction and scale by
    link bandwidth at cost time).  The 'pod' axis crosses DCN: modelled as a
    switch star with 1 unit per pod (skinny), which is where the paper's
    edge splitting matters.
    """
    from .zoo import bidir_ring, star_switch
    if axis_size == 1:
        return DiGraph(1, frozenset({0}), {}, f"{axis_name}-trivial")
    if axis_name == "pod":
        if axis_size == 2:
            # 2 pods: direct bidirectional DCN pipe
            return DiGraph(2, frozenset({0, 1}), {(0, 1): 1, (1, 0): 1},
                           "pod-pipe")
        return star_switch(axis_size, cap=1)
    return bidir_ring(axis_size, cap=1, name=f"{axis_name}-ring{axis_size}")
