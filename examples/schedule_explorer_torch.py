"""Explore the port's schedule compiler on any topology: optimality search,
edge splitting, tree packing, chunked pipelining, physical-link loads —
then run the explored programs on the topology's ranks stacked on the card
(`repro_torch.comms.Stacked`).  The counterpart of
examples/schedule_explorer.py, through `repro_torch.api.Collectives`; its
schedule-level lines are the reference example's.

``--topo`` takes a committed zoo row name OR any `TopologySpec` string
(full grammar, transforms included) — no code edit needed for new fabrics:

    PYTHONPATH=src python examples/schedule_explorer_torch.py --topo dragonfly
    PYTHONPATH=src python examples/schedule_explorer_torch.py \
        --topo "torus2d:6x6@fail(0-1)"
    PYTHONPATH=src python examples/schedule_explorer_torch.py \
        --topo hypercube3 --cache /tmp/schedules  # second run replays
    PYTHONPATH=src python examples/schedule_explorer_torch.py \
        --topo circulant16 --kind alltoall   # per-source pruned scatter
    PYTHONPATH=src python examples/schedule_explorer_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.api import Collectives
from repro_torch.comms import Stacked
from repro_torch.kernels.chunk_accum import KERNEL as CHUNK_ACCUM
from repro_torch.core import (simulate_allgather, simulate_allreduce,
                        simulate_alltoall, rs_ag_allreduce_runtime,
                        re_bc_allreduce_runtime)
from repro_torch.models.common import resolve_device
from repro_torch.topo import resolve_topology, zoo_specs


def run_stacked(coll: Collectives, g, kind: str, device) -> None:
    """The explored collective (and, for allgather, the allreduce) on the
    topology's ranks stacked on `device`, against the plain result."""
    a = g.num_compute
    comm = Stacked(a)
    gen = torch.Generator().manual_seed(0)
    before = CHUNK_ACCUM.launches
    if kind == "alltoall":
        x = torch.randn((a, a, 64), generator=gen).to(device)
        got = coll.executable(g, kind="alltoall", comm=comm)(x)
        torch.testing.assert_close(got, x.transpose(0, 1), rtol=0, atol=0)
    else:
        x = torch.randn((a, 256), generator=gen).to(device)
        got = coll.executable(g, kind="allgather", comm=comm)(x)
        torch.testing.assert_close(got, x[None].expand(a, a, 256), rtol=0,
                                   atol=0)
        x = torch.randn((a, a * 256), generator=gen).to(device)
        got = coll.executable(g, kind="allreduce", comm=comm)(x)
        torch.testing.assert_close(got, x.sum(0).expand(a, -1), rtol=1e-5,
                                   atol=1e-5)
    print(f"\nexecuted {kind}{' and allreduce' if kind != 'alltoall' else ''}"
          f" on {a} stacked ranks ({device}): equal to the plain result")
    print(f"chunk_accum launches: {CHUNK_ACCUM.launches - before}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topo", default="fig1a",
                    help="zoo row name or TopologySpec string "
                         f"(zoo: {', '.join(sorted(zoo_specs()))})")
    ap.add_argument("--kind", default="allgather",
                    choices=("allgather", "alltoall"),
                    help="primary collective to explore (allreduce always "
                         "rides along for allgather)")
    ap.add_argument("--chunks", type=int, default=32)
    ap.add_argument("--cache", default="",
                    help="schedule artifact cache dir (skip recompilation)")
    ap.add_argument("--device", default="cuda",
                    help="where the stacked ranks run (cuda: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    g = resolve_topology(args.topo)
    print(g.describe())
    # alltoall pipelines over the N-1 destination blocks, not over chunk
    # subdivisions — P=1 is the sweep-grade configuration
    chunks = 1 if args.kind == "alltoall" else args.chunks
    coll = Collectives(cache=args.cache or None, num_chunks=chunks,
                       verify=True)
    sched = coll.schedule(g, kind=args.kind)
    if coll.cache is not None:
        print(coll.cache.describe())
    print(f"\n{args.kind}: {sched.describe()}")
    print(f"tree classes: {len(sched.classes)}  "
          f"(depths <= {sched.depth})")
    sim = (simulate_alltoall if args.kind == "alltoall"
           else simulate_allgather)
    rep = sim(sched)
    print(f"simulated: {rep.describe()}")
    print("\nbusiest physical links (bytes, per unit data):")
    top = sorted(rep.link_bytes.items(), key=lambda kv: -kv[1])[:8]
    for (u, v), b in top:
        print(f"  {u:3d} -> {v:3d}: {float(b):.4f}")
    if args.kind != "alltoall":
        print(f"\nallreduce RS+AG factor: {rs_ag_allreduce_runtime(g)} "
              f"vs RE+BC {re_bc_allreduce_runtime(g)}")
        ar = simulate_allreduce(coll.schedule(g, kind="allreduce"))
        print(f"allreduce achieved: {ar.describe()}")
    run_stacked(coll, g, args.kind, device)


if __name__ == "__main__":
    main()
