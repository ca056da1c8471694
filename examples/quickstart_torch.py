"""Quickstart over the PyTorch port: compile a bandwidth-optimal collective
schedule for a switch topology, inspect it, verify it, and execute it on
the card — through the port's front doors, `repro_torch.topo.TopologySpec`
(declarative topologies) and `repro_torch.api.Collectives` (schedules).
The counterpart of examples/quickstart.py; its schedule-level lines are
the reference example's.

The allgather and reduce-scatter programs run on the 8 ranks of fig1a
stacked as the leading dim of one tensor (`repro_torch.comms.Stacked`):
each reduce-scatter round lands through the hand-written `chunk_accum`
kernel.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.api import Collectives
from repro_torch.comms import Stacked
from repro_torch.core import simulate_allgather, solve_optimality
from repro_torch.core.optimality import allgather_inv_xstar
from repro_torch.kernels.chunk_accum import KERNEL as CHUNK_ACCUM
from repro_torch.models.common import resolve_device
from repro_torch.topo import TopologySpec, resolve_topology


SHARD_ELEMS = 1 << 16          # float32 values in each rank's shard


def run_stacked(coll: Collectives, g, device) -> None:
    """fig1a's allgather and reduce-scatter on its stacked ranks, each rank
    holding SHARD_ELEMS float32 values a shard, against the plain
    result."""
    elems = SHARD_ELEMS
    a = g.num_compute
    comm = Stacked(a)
    gen = torch.Generator().manual_seed(0)
    shards = torch.randn((a, elems), generator=gen).to(device)
    gather = coll.executable(g, kind="allgather", comm=comm, num_chunks=64)
    got = gather(shards)
    want = shards[None].expand(a, a, elems)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    full = torch.randn((a, a * elems), generator=gen).to(device)
    scatter = coll.executable(g, kind="reduce_scatter", comm=comm,
                              num_chunks=64)
    before = CHUNK_ACCUM.launches
    got = scatter(full)
    want = full.sum(0).view(a, elems)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    print(f"\nexecuted on {a} stacked ranks ({device}): allgather exact, "
          f"reduce-scatter within 1e-5 of the plain sum")
    print(f"chunk_accum launches: {CHUNK_ACCUM.launches - before}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the stacked ranks run (cuda: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. the paper's Figure 1a topology: 8 compute nodes, 2 clusters,
    #    3 switches; thick links have 10x bandwidth
    g = resolve_topology("fig1a")
    print(g.describe())

    # 2. §2.1: exact optimal bandwidth runtime via maxflow binary search
    opt = solve_optimality(g)
    print(f"\noptimal T_B = (M/N) * {opt.inv_x_star}   (U={opt.U}, k={opt.k})")
    ring = allgather_inv_xstar(resolve_topology("fig1d"))
    print(f"TACCL/TACOS-style ring unwinding would give (M/N) * {ring} "
          f"-> {ring / opt.inv_x_star}x worse")

    # 3. §2.2+2.3: edge splitting + arborescence packing + pipelining
    coll = Collectives()
    sched = coll.schedule(g, kind="allgather", num_chunks=64, verify=True)
    print(f"\nschedule: {sched.describe()}")

    # 4. verify + simulate on the physical topology
    rep = simulate_allgather(sched)
    print(f"simulated: {rep.describe()}")
    assert rep.ratio < 1.05, "should be within 5% of optimal at P=64"
    print("\nOK: schedule is provably correct and bandwidth-optimal.")

    # 5. declarative what-if: degrade a DCN link, recompile, compare
    degraded = TopologySpec.parse("two_cluster:4,10,2@degrade(0-8,cap=1)")
    print(f"\nwhat-if {degraded}: "
          f"inv_x*={coll.schedule(degraded, num_chunks=64).opt.inv_x_star}")

    # 6. execute the allgather and reduce-scatter on the stacked ranks
    run_stacked(coll, g, device)


if __name__ == "__main__":
    main()
