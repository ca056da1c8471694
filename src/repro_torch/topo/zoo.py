"""Topology zoo — every topology family the paper discusses plus TPU shapes.

All constructors return `DiGraph` with integer capacities.  Compute nodes are
always numbered first (0..N-1), switches after, so compute node ids coincide
with device/rank ids in the runtime.

Every constructor self-registers as a `repro.topo.spec.TopologySpec` family
(the `@register_topology` decorator), and the committed sweep zoo lives here
as the declarative `ZOO_SPECS` table — `sweep_registry()`, BENCH row names,
cache keys and the ``--topology`` CLI all derive from it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.graph import DiGraph, Edge

from .spec import register_topology, register_transform


# ---------------------------------------------------------------------- #
# direct-connect basics
# ---------------------------------------------------------------------- #

@register_topology("ring", pattern="{n}")
def ring(n: int, cap: int = 1, name: str | None = None) -> DiGraph:
    """Unidirectional ring 0 -> 1 -> ... -> n-1 -> 0."""
    edges = {(i, (i + 1) % n): cap for i in range(n)}
    return DiGraph(n, frozenset(range(n)), edges, name or f"ring{n}")


@register_topology("bring", pattern="{n}")
def bidir_ring(n: int, cap: int = 1, name: str | None = None) -> DiGraph:
    edges: Dict[Edge, int] = {}
    for i in range(n):
        edges[(i, (i + 1) % n)] = cap
        edges[((i + 1) % n, i)] = cap
    return DiGraph(n, frozenset(range(n)), edges, name or f"bring{n}")


@register_topology("line", pattern="{n}")
def line(n: int, cap: int = 1) -> DiGraph:
    """Bidirectional path graph — the pathological non-symmetric case."""
    edges: Dict[Edge, int] = {}
    for i in range(n - 1):
        edges[(i, i + 1)] = cap
        edges[(i + 1, i)] = cap
    return DiGraph(n, frozenset(range(n)), edges, f"line{n}")


@register_topology("full", pattern="{n}")
def fully_connected(n: int, cap: int = 1) -> DiGraph:
    edges = {(i, j): cap for i in range(n) for j in range(n) if i != j}
    return DiGraph(n, frozenset(range(n)), edges, f"full{n}")


@register_topology("torus2d", pattern="{rows}x{cols}")
def torus_2d(rows: int, cols: int, cap: int = 1,
             wrap: bool = True) -> DiGraph:
    """2-D (wrapped) torus — the TPU ICI shape.  Bidirectional links."""
    n = rows * cols

    def nid(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    edges: Dict[Edge, int] = {}
    for r in range(rows):
        for c in range(cols):
            u = nid(r, c)
            nbrs = []
            if wrap or c + 1 < cols:
                nbrs.append(nid(r, c + 1))
            if wrap or r + 1 < rows:
                nbrs.append(nid(r + 1, c))
            for v in nbrs:
                if u == v:
                    continue
                edges[(u, v)] = edges.get((u, v), 0) + cap
                edges[(v, u)] = edges.get((v, u), 0) + cap
    return DiGraph(n, frozenset(range(n)), edges,
                   f"torus{rows}x{cols}" + ("" if wrap else "-mesh"))


@register_topology("hypercube", pattern="{dim}")
def hypercube(dim: int, cap: int = 1) -> DiGraph:
    """dim-dimensional binary hypercube, bidirectional links."""
    n = 1 << dim
    edges: Dict[Edge, int] = {}
    for u in range(n):
        for b in range(dim):
            v = u ^ (1 << b)
            edges[(u, v)] = cap
    return DiGraph(n, frozenset(range(n)), edges, f"hcube{dim}")


@register_topology("circulant", pattern="n{n},s{lo}-{hi}")
def circulant(n: int, lo: int = 1, hi: int = 4, cap: int = 1) -> DiGraph:
    """Circulant direct-connect C_n(lo..hi): node i links to i ± s (mod n)
    for every stride s in [lo, hi] — the symmetric direct-connect family
    the all-to-all shuffle literature builds its schedules on.  Each stride
    contributes one bidirectional ring, so the graph is vertex-transitive
    and Eulerian.  When a stride satisfies 2s ≡ 0 (mod n) its two
    directions coincide and the shared link accumulates double capacity."""
    if not (1 <= lo <= hi < n):
        raise ValueError(f"need 1 <= lo <= hi < n, got s{lo}-{hi} on n={n}")
    edges: Dict[Edge, int] = {}
    for i in range(n):
        for s in range(lo, hi + 1):
            j = (i + s) % n
            if j == i:
                continue
            edges[(i, j)] = edges.get((i, j), 0) + cap
            edges[(j, i)] = edges.get((j, i), 0) + cap
    return DiGraph(n, frozenset(range(n)), edges, f"circulant{n}s{lo}-{hi}")


@register_topology("torus3d", pattern="{x}x{y}x{z}")
def torus_3d(x: int, y: int, z: int, cap: int = 1) -> DiGraph:
    n = x * y * z

    def nid(i: int, j: int, kk: int) -> int:
        return ((i % x) * y + (j % y)) * z + (kk % z)

    edges: Dict[Edge, int] = {}
    for i in range(x):
        for j in range(y):
            for kk in range(z):
                u = nid(i, j, kk)
                for v in (nid(i + 1, j, kk), nid(i, j + 1, kk),
                          nid(i, j, kk + 1)):
                    if u == v:
                        continue
                    edges[(u, v)] = edges.get((u, v), 0) + cap
                    edges[(v, u)] = edges.get((v, u), 0) + cap
    return DiGraph(n, frozenset(range(n)), edges, f"torus{x}x{y}x{z}")


# ---------------------------------------------------------------------- #
# switch topologies
# ---------------------------------------------------------------------- #

@register_topology("star", pattern="{n}")
def star_switch(n: int, cap: int = 1) -> DiGraph:
    """n compute nodes hanging off one switch (id n)."""
    edges: Dict[Edge, int] = {}
    for i in range(n):
        edges[(i, n)] = cap
        edges[(n, i)] = cap
    return DiGraph(n + 1, frozenset(range(n)), edges, f"star{n}")


@register_topology("two_cluster", pattern="{per_cluster},{local_cap},{global_cap}")
def two_cluster_switch(per_cluster: int = 4, local_cap: int = 10,
                       global_cap: int = 1) -> DiGraph:
    """The paper's Figure 1a: two clusters of `per_cluster` compute nodes,
    one local switch per cluster (local_cap links), one global switch
    (global_cap links per node).  Bottleneck = the cluster cut."""
    n = 2 * per_cluster
    g_sw = n          # global switch v0
    sw1 = n + 1       # cluster-1 switch v1
    sw2 = n + 2       # cluster-2 switch v2
    edges: Dict[Edge, int] = {}
    for i in range(per_cluster):
        edges[(i, sw1)] = local_cap
        edges[(sw1, i)] = local_cap
    for i in range(per_cluster, n):
        edges[(i, sw2)] = local_cap
        edges[(sw2, i)] = local_cap
    for i in range(n):
        edges[(i, g_sw)] = global_cap
        edges[(g_sw, i)] = global_cap
    return DiGraph(n + 3, frozenset(range(n)), edges,
                   f"fig1a[{per_cluster}x2,{local_cap}/{global_cap}]")


@register_topology("fig1a")
def fig1a() -> DiGraph:
    """Paper Figure 1a with b = 1."""
    return two_cluster_switch(4, 10, 1)


@register_topology("fig1d")
def fig1d_ring_unwound() -> DiGraph:
    """Paper Figure 1d: the *suboptimal* TACCL/TACOS-style unwinding of
    Fig 1a into directed rings (each node's switch egress feeds the next
    node's ingress).  Local switches become intra-cluster rings (cap 10),
    the global switch one global ring (cap 1).  The bottleneck cut's egress
    drops from 4b to b — 4x worse (paper §2 discussion)."""
    edges: Dict[Edge, int] = {}
    for base in (0, 4):  # intra-cluster directed rings, cap 10
        for i in range(4):
            u = base + i
            v = base + (i + 1) % 4
            edges[(u, v)] = edges.get((u, v), 0) + 10
    for i in range(8):   # global directed ring, cap 1
        u, v = i, (i + 1) % 8
        edges[(u, v)] = edges.get((u, v), 0) + 1
    return DiGraph(8, frozenset(range(8)), edges, "fig1d-ring-unwound")


@register_topology("fattree", pattern="{pods}p{leaf_per_pod}l{hosts_per_leaf}h")
def fat_tree(pods: int = 4, leaf_per_pod: int = 2, hosts_per_leaf: int = 2,
             host_cap: int = 1, up_cap: int | None = None) -> DiGraph:
    """Two-level fat tree: hosts -> leaf switches -> spine switches.
    TACCL/TACOS cannot handle multi-switch fabrics like this (paper §2);
    edge splitting removes every switch exactly."""
    n_hosts = pods * leaf_per_pod * hosts_per_leaf
    up_cap = up_cap if up_cap is not None else hosts_per_leaf * host_cap
    n_leaf = pods * leaf_per_pod
    spine = n_hosts + n_leaf  # one spine switch (folded core)
    edges: Dict[Edge, int] = {}
    for h in range(n_hosts):
        leaf = n_hosts + h // hosts_per_leaf
        edges[(h, leaf)] = host_cap
        edges[(leaf, h)] = host_cap
    for l in range(n_leaf):
        leaf = n_hosts + l
        edges[(leaf, spine)] = up_cap
        edges[(spine, leaf)] = up_cap
    return DiGraph(n_hosts + n_leaf + 1, frozenset(range(n_hosts)), edges,
                   f"fattree[{pods}p{leaf_per_pod}l{hosts_per_leaf}h]")


@register_topology("dragonfly", pattern="g{groups},p{per_group}")
def dragonfly(groups: int = 3, per_group: int = 2, local_cap: int = 4,
              global_cap: int = 1) -> DiGraph:
    """Dragonfly-lite: per-group router (switch) with all-to-all global links
    between routers; compute nodes hang off their group router."""
    n = groups * per_group
    edges: Dict[Edge, int] = {}
    for g in range(groups):
        router = n + g
        for i in range(per_group):
            h = g * per_group + i
            edges[(h, router)] = local_cap
            edges[(router, h)] = local_cap
    for g1 in range(groups):
        for g2 in range(groups):
            if g1 != g2:
                edges[(n + g1, n + g2)] = global_cap
    return DiGraph(n + groups, frozenset(range(n)), edges,
                   f"dragonfly[{groups}x{per_group}]")


@register_topology("dgx", pattern="{n}")
def dgx_box(n: int = 8, nvlink_cap: int = 12, nic_cap: int = 1) -> DiGraph:
    """A DGX-like box: fully-connected NVLink between n GPUs + a NIC switch
    (models the egress bottleneck when boxes join a fabric)."""
    edges = {(i, j): nvlink_cap for i in range(n) for j in range(n) if i != j}
    sw = n
    for i in range(n):
        edges[(i, sw)] = nic_cap
        edges[(sw, i)] = nic_cap
    return DiGraph(n + 1, frozenset(range(n)), edges, f"dgx{n}")


@register_topology("bcube", pattern="{n}")
def bcube(n: int = 2, cap: int = 1) -> DiGraph:
    """BCube_1(n): n² servers, n level-0 switches (one per pod of n servers)
    and n level-1 switches (one per within-pod index).  Server (p, i) =
    id p·n+i connects to level-0 switch p and level-1 switch i."""
    servers = n * n
    edges: Dict[Edge, int] = {}
    for p in range(n):
        for i in range(n):
            h = p * n + i
            lvl0 = servers + p
            lvl1 = servers + n + i
            for sw in (lvl0, lvl1):
                edges[(h, sw)] = cap
                edges[(sw, h)] = cap
    return DiGraph(servers + 2 * n, frozenset(range(servers)), edges,
                   f"bcube{n}")


@register_topology("meshdgx", pattern="{rows}x{cols}x{gpus}")
def mesh_of_dgx(rows: int = 2, cols: int = 2, gpus: int = 2,
                nvlink_cap: int = 4, dcn_cap: int = 1) -> DiGraph:
    """2-D (non-wrapping) mesh of DGX-style boxes: each box is `gpus`
    NVLink-fully-connected GPUs behind one NIC switch; NIC switches link to
    their mesh neighbours with `dcn_cap` per direction, and every GPU feeds
    its box switch with `dcn_cap`.  All links bidirectional -> Eulerian."""
    boxes = rows * cols
    n = boxes * gpus

    def sw(r: int, c: int) -> int:
        return n + r * cols + c

    edges: Dict[Edge, int] = {}
    for b in range(boxes):
        base = b * gpus
        for i in range(gpus):
            for j in range(gpus):
                if i != j:
                    edges[(base + i, base + j)] = nvlink_cap
            edges[(base + i, n + b)] = dcn_cap
            edges[(n + b, base + i)] = dcn_cap
    for r in range(rows):
        for c in range(cols):
            for (r2, c2) in ((r, c + 1), (r + 1, c)):
                if r2 < rows and c2 < cols:
                    edges[(sw(r, c), sw(r2, c2))] = dcn_cap
                    edges[(sw(r2, c2), sw(r, c))] = dcn_cap
    return DiGraph(n + boxes, frozenset(range(n)), edges,
                   f"meshdgx{rows}x{cols}x{gpus}")


# ---------------------------------------------------------------------- #
# degraded / failed-link variants
# ---------------------------------------------------------------------- #

@register_transform("fail")
def fail_link(g: DiGraph, u: int, v: int, name: str | None = None) -> DiGraph:
    """Remove the bidirectional link u<->v (both directed edges must exist,
    with equal capacity, so the result stays Eulerian)."""
    if g.cap.get((u, v)) != g.cap.get((v, u)) or (u, v) not in g.cap:
        raise ValueError(f"{g.name}: ({u},{v}) is not a symmetric link")
    cap = {e: c for e, c in g.cap.items() if e not in ((u, v), (v, u))}
    out = DiGraph(g.num_nodes, g.compute, cap,
                  name or f"{g.name}@fail({u}-{v})")
    if not out.is_eulerian():
        raise ValueError(f"{g.name}: failing ({u},{v}) breaks Eulerian-ness")
    return out


@register_transform("degrade")
def degrade_link(g: DiGraph, u: int, v: int, cap: int,
                 name: str | None = None) -> DiGraph:
    """Reduce the bidirectional link u<->v to `cap` per direction (models a
    partially failed NVLink/NIC bundle; stays Eulerian by symmetry)."""
    if g.cap.get((u, v)) != g.cap.get((v, u)) or (u, v) not in g.cap:
        raise ValueError(f"{g.name}: ({u},{v}) is not a symmetric link")
    if not (0 < cap < g.cap[(u, v)]):
        raise ValueError(f"degraded capacity {cap} must be in "
                         f"(0, {g.cap[(u, v)]})")
    new = dict(g.cap)
    new[(u, v)] = new[(v, u)] = cap
    return DiGraph(g.num_nodes, g.compute, new,
                   name or f"{g.name}@degrade({u}-{v},cap={cap})")


# ---------------------------------------------------------------------- #
# the committed sweep zoo, declaratively
# ---------------------------------------------------------------------- #

#: Row name -> spec string for every committed sweep/BENCH topology.  This
#: is the ONE hand-maintained table: `repro.topo.spec.zoo_specs()` parses
#: it, `repro.cache.sweep.sweep_registry()` builds from it, BENCH row names
#: are its keys, and degraded/failed variants get their canonical
#: spec-derived display names from the transform suffixes.
ZOO_SPECS: Dict[str, str] = {
    "fig1a": "fig1a",
    "fig1a_degraded": "two_cluster:4,10,2@degrade(0-8,cap=1)",
    "ring8": "ring:8",
    "bring8": "bring:8",
    "bring8_degraded": "bring:8,cap=2@degrade(0-1,cap=1)",
    "line6": "line:6",
    "torus4x4": "torus2d:4x4",
    "torus3x3_failed": "torus2d:3x3@fail(0-1)",
    "hypercube3": "hypercube:3",
    "hypercube3_failed": "hypercube:3@fail(0-1)",
    "bcube2": "bcube:2",
    "bcube3": "bcube:3",
    "meshdgx2x2": "meshdgx:2x2x2",
    "meshdgx2x2_degraded": "meshdgx:2x2x2,dcn_cap=2@degrade(8-9,cap=1)",
    "fattree": "fattree",
    "dragonfly": "dragonfly",
    "dgx8": "dgx:8",
    "star8": "star:8",
    # direct-connect circulants from the all-to-all literature: every node
    # reaches i±s for strides s in the range — dense enough that the
    # per-source scatter trees stay shallow
    "circulant8": "circulant:n8,s1-2",
    "circulant16": "circulant:n16,s1-4",
    "two_cluster_3x6": "two_cluster:3,6,2",
    "multipod": "multipod:2x4",
    # scaled-up rows: the split/pack hot paths dominate even harder here
    # (64 compute nodes, multi-switch fabrics) — these are the rows the
    # warm-started oracle engine is proven on
    "torus8x8": "torus2d:8x8",
    "torus8x8_failed": "torus2d:8x8@fail(0-1)",
    "fattree8p4l2h": "fattree:8p4l2h",
    "fattree8p4l2h_degraded": "fattree:8p4l2h,host_cap=2@degrade(0-64,cap=1)",
    "fattree8p4l4h": "fattree:8p4l4h",
    "dragonfly6x4": "dragonfly:g6,p4",
    "dragonfly6x4_degraded": "dragonfly:g6,p4@degrade(0-24,cap=2)",
    # 256-node fabric: the largest committed row — the compact-CSR maxflow
    # substrate is what makes sweeping this tractable
    "torus16x16": "torus2d:16x16",
}
