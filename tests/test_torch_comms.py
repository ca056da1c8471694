"""The port's collective layer against the JAX reference on the CPU: the
schedule compiler copy and its lowering field by field, the chunk_accum plain
versions against the Pallas kernel (interpret mode) and `.at[].add`, the
stacked tree collectives (allgather, reduce-scatter, allreduce, broadcast,
reduce, alltoall) bit-equal to the JAX `tree_*` under forced host devices,
and the P2P form over gloo at world 4 bit-equal to the stacked form (and
its alltoall to `dist.all_to_all_single`).

Every comparison here is exact: the schedules are integer tables, and the
collectives add the same float32 values in the same order."""
import ctypes
import os
import re
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Collectives as JaxCollectives
from repro.kernels.chunk_accum import chunk_accum as jax_chunk_accum
from repro.topo.tpu import axis_topology_for_mesh as jax_axis_topology
from repro_torch.api import Collectives
from repro_torch.comms import (BucketedAllReduce, CollectiveContext, Stacked,
                               compressed_all_reduce, partition_buckets,
                               tree_all_gather, tree_all_reduce,
                               tree_all_to_all, tree_broadcast, tree_reduce,
                               tree_reduce_scatter)
from repro_torch.kernels import (CHUNK_ACCUM_KERNEL, build, chunk_accum,
                                 chunk_accum_indexed)
from repro_torch.kernels.chunk_accum import ARGTYPES
from repro_torch.models import moe as tmoe
from repro_torch.topo import axis_topology_for_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------- #
# the compiler copy
# ---------------------------------------------------------------------- #

# the specs of tests/golden/*.json, then bring:8, dgx:8 and data-ring8
GOLDEN_CASES = [
    ("fig1a", dict(kind="allgather", num_chunks=8)),
    ("bring:8", dict(kind="allgather", num_chunks=8)),
    ("two_cluster:3,6,2", dict(kind="allgather", num_chunks=8)),
    ("fig1a", dict(kind="broadcast", root=0, num_chunks=8)),
    ("bring:8", dict(kind="reduce", root=0, num_chunks=8)),
    ("fig1a", dict(kind="alltoall", num_chunks=1)),
    ("dragonfly", dict(kind="allreduce", num_chunks=8)),
]
EXTRA_SPECS = ["bring:8", "dgx:8", "data-ring8"]


def _topos(spec):
    """(JAX DiGraph or spec, port DiGraph or spec) for one case."""
    if spec == "data-ring8":
        return jax_axis_topology("data", 8), axis_topology_for_mesh("data", 8)
    return spec, spec


def _sched_fields(s):
    return dict(kind=s.kind, root=s.root, num_chunks=s.num_chunks, k=s.k,
                slots_per_shard=s.slots_per_shard,
                claimed=s.claimed_runtime,
                topo=s.topo.fingerprint(),
                rounds=[[tuple(send) for send in rnd] for rnd in s.rounds])


def _prog_fields(p):
    return dict(kind=p.kind, axis_size=p.axis_size, num_slots=p.num_slots,
                slots_per_shard=p.slots_per_shard, root=p.root,
                calls=[[(c.perm, c.width, c.send_slots.tolist(),
                         c.recv_slots.tolist()) for c in rnd]
                       for rnd in p.rounds])


def _assert_same(jax_art, port_art, jc, tc):
    halves = (("rs", "ag") if hasattr(port_art, "rs") else (None,))
    for h in halves:
        js = getattr(jax_art, h) if h else jax_art
        ts = getattr(port_art, h) if h else port_art
        assert _sched_fields(ts) == _sched_fields(js)
        assert _prog_fields(tc.lower(ts)) == _prog_fields(jc.lower(js))


@pytest.mark.parametrize("spec,opts", GOLDEN_CASES + [
    (s, dict(kind="allreduce", num_chunks=8)) for s in EXTRA_SPECS])
def test_schedule_and_lowering_equal_the_reference(spec, opts):
    jt, tt = _topos(spec)
    jc, tc = JaxCollectives(), Collectives()
    _assert_same(jc.schedule(jt, **opts), tc.schedule(tt, **opts), jc, tc)


@pytest.mark.parametrize("spec", ["fig1a", "bring:8", "two_cluster:3,6,2",
                                  "dragonfly"] + EXTRA_SPECS)
def test_pair_equals_the_reference(spec):
    jt, tt = _topos(spec)
    jc, tc = JaxCollectives(), Collectives()
    for js, ts in zip(jc.pair(jt), tc.pair(tt)):
        _assert_same(js, ts, jc, tc)


def test_facade_refuses_what_is_not_ported():
    """Every kind the compiler emits has an executor over Stacked(8): each
    returned callable computes its collective; only an unknown kind is
    refused."""
    cc, comm = Collectives(), Stacked(8)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, 5, generator=g)

    def run(kind, v, **kw):
        return cc.executable("bring:8", kind=kind, comm=comm, **kw)(v)
    torch.testing.assert_close(run("allreduce", x), x.sum(0).expand(8, 16, 5))
    assert torch.equal(run("allgather", x), x[None].expand(8, 8, 16, 5))
    torch.testing.assert_close(run("reduce_scatter", x),
                               x.sum(0).view(8, 2, 5))
    assert torch.equal(run("broadcast", x, root=3), x[3].expand(8, 16, 5))
    torch.testing.assert_close(run("reduce", x, root=3)[3], x.sum(0))
    blocks = torch.randn(8, 8, 3, generator=g)
    assert torch.equal(run("alltoall", blocks, num_chunks=1),
                       blocks.transpose(0, 1))
    with pytest.raises(ValueError):
        cc.executable("bring:8", kind="gather", comm=comm)


def test_context_uses_the_reference_axis_model_and_overrides():
    ctx = CollectiveContext({"data": 8, "model": 1},
                            topologies={"pod": "dgx:8"})
    assert ctx.topology("data").name == "data-ring8"
    assert ctx.topology("pod").fingerprint() == \
        Collectives().topology("dgx:8").fingerprint()
    text = ctx.describe()
    assert "axis data: data-ring8" in text and "trivial" in text
    ar = ctx.allreduce_schedule("data")
    assert ctx.allreduce_schedule("data") is ar
    red = ctx.bucketed_allreduce("data", Stacked(8), wire_dtype=None)
    assert red.wire_dtype is None and red.rs_prog.kind == "reduce_scatter"


# ---------------------------------------------------------------------- #
# chunk_accum: plain versions and the wrapper on the CPU
# ---------------------------------------------------------------------- #

def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
         torch.float16: jnp.float16}[t.dtype])


@pytest.mark.parametrize("shape", [(8, 512), (16, 1024), (4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_chunk_accum_plain_equals_pallas_interpret(shape, dtype):
    g = torch.Generator().manual_seed(shape[0] * shape[1])
    acc = torch.randn(*shape, generator=g)
    upd = torch.randn(*shape, generator=g).to(dtype)
    ref = jax_chunk_accum(_jnp(acc), _jnp(upd), interpret=True)
    got = chunk_accum(acc.clone(), upd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("width,cols", [(1, 7), (3, 64), (8, 1003)])
def test_chunk_accum_indexed_plain_equals_at_add(dtype, width, cols):
    """The trash row (here the last) may repeat; it is skipped, so every
    other row is compared with the reference's scatter-add."""
    g = torch.Generator().manual_seed(width * cols)
    rows = 4 * width + 1
    trash = rows - 1
    acc = torch.randn(rows, cols, generator=g)
    idx = torch.cat([torch.randperm(trash, generator=g)[:width],
                     torch.full((3,), trash)])
    upd = torch.randn(width + 3, cols, generator=g).to(dtype)
    ref = _jnp(acc).at[jnp.asarray(idx.numpy())].add(
        _jnp(upd).astype(jnp.float32))
    got = chunk_accum_indexed(acc.clone(), idx, upd, trash)
    np.testing.assert_array_equal(got[:trash].numpy(),
                                  np.asarray(ref)[:trash])
    np.testing.assert_array_equal(got[trash].numpy(), acc[trash].numpy())


def test_chunk_accum_on_cpu_takes_plain_path_without_launch():
    acc, upd = torch.zeros(4, 8), torch.ones(4, 8)
    before = CHUNK_ACCUM_KERNEL.launches
    chunk_accum(acc, upd)
    chunk_accum_indexed(acc, torch.tensor([1, 3]), upd[:2], 3)
    assert CHUNK_ACCUM_KERNEL.launches == before
    assert CHUNK_ACCUM_KERNEL._lib is None      # nothing built or loaded
    assert acc[1].eq(2).all() and acc[3].eq(1).all()


def test_chunk_accum_refuses_bad_arguments():
    acc = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="float32"):
        chunk_accum(acc.double(), acc)
    with pytest.raises(ValueError, match="bfloat16"):
        chunk_accum(acc, acc.double())
    with pytest.raises(ValueError, match=r"\[\*, C\]"):
        chunk_accum(acc, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="int64"):
        chunk_accum_indexed(acc, torch.tensor([0], dtype=torch.int32),
                            acc[:1], 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        chunk_accum(acc.to("meta"), acc.to("meta"))


def test_chunk_accum_ctypes_signature_matches_the_c_entry_point():
    """The kernel builds only on the card, so the binding's argument list is
    held here against the C prototype in the source."""
    src = (build.CSRC / "chunk_accum.cu").read_text()
    params = re.search(r"int repro_chunk_accum\((.*?)\)", src,
                       re.S).group(1)
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "int64_t": ctypes.c_int64, "int64_t*": ctypes.c_void_p}
    declared = [c_types[re.sub(r"^const ", "", p.strip()).rsplit(" ", 1)[0]
                        .replace(" *", "*")]
                for p in params.split(",")]
    assert declared == ARGTYPES


# ---------------------------------------------------------------------- #
# tree collectives: stacked form vs the JAX tree_* on forced host devices
# ---------------------------------------------------------------------- #

TREE_SPECS = ["bring:8", "fig1a", "bring:4"]
DTYPES = ["float32", "bfloat16"]
# (spec, dtype, functions): bf16 allgather is a pure copy, held by the bf16
# allreduce's gather; fig1a (a switched fabric) runs in f32 only
# the rooted kinds (broadcast, reduce) at roots 0 and 3, and the alltoall,
# over every spec in both dtypes
ROOTED = "bc0 bc3 rd0 rd3 a2a"
TREE_CASES = ([(spec, "float32", "rs ag ar") for spec in TREE_SPECS]
              + [(spec, "bfloat16", "rs ar") for spec in ("bring:8",
                                                          "bring:4")]
              + [(spec, dt, ROOTED) for spec in TREE_SPECS for dt in DTYPES])

JAX_TREE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
try:
    from jax import shard_map
except ImportError:  # older jax: experimental namespace
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.api import Collectives
from repro.comms import (tree_all_gather, tree_all_reduce, tree_all_to_all,
                         tree_broadcast, tree_reduce, tree_reduce_scatter)
from repro.comms.collectives import tree_all_reduce_multi

data = np.load(sys.argv[1])
cc = Collectives()
out = {}
for case in sys.argv[3].split(";"):
    spec, dt, *kinds = case.split()
    rs = cc.program(spec, kind="reduce_scatter")
    ag = cc.program(spec, kind="allgather")
    rs_ar, ag_ar = cc.program(spec, kind="allreduce")
    bc = {r: cc.program(spec, kind="broadcast", root=r) for r in (0, 3)}
    rd = {r: cc.program(spec, kind="reduce", root=r) for r in (0, 3)}
    a2a = cc.program(spec, kind="alltoall", num_chunks=1)
    a = rs.axis_size
    mesh = Mesh(np.array(jax.devices()[:a]), ("x",))
    fns = {"rs": lambda v: tree_reduce_scatter(v[0], rs, "x")[None],
           "ag": lambda v: tree_all_gather(v[0], ag, "x")[None],
           "ar": lambda v: tree_all_reduce(v[0], rs_ar, ag_ar, "x")[None],
           "bc0": lambda v: tree_broadcast(v[0], bc[0], "x")[None],
           "bc3": lambda v: tree_broadcast(v[0], bc[3], "x")[None],
           "rd0": lambda v: tree_reduce(v[0], rd[0], "x")[None],
           "rd3": lambda v: tree_reduce(v[0], rd[3], "x")[None],
           "a2a": lambda v: tree_all_to_all(v[0], a2a, "x")[None]}
    fn = jax.jit(shard_map(lambda *xs: tuple(fns[k](x) for k, x in
                                             zip(kinds, xs)),
                           mesh=mesh, in_specs=(P("x"),) * len(kinds),
                           out_specs=(P("x"),) * len(kinds)))
    xs = [jnp.asarray(data[f"{spec}/{k}"]).astype(dt) for k in kinds]
    for k, y in zip(kinds, fn(*xs)):
        out[f"{spec}/{dt}/{k}"] = np.asarray(y.astype(jnp.float32))

# two axes of 2 over four devices, as the P2P test runs them
rs2, ag2 = cc.program("bring:2", kind="allreduce")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
fn = jax.jit(shard_map(
    lambda x: tree_all_reduce_multi(
        x[0], (("a", rs2, ag2), ("b", rs2, ag2)))[None],
    mesh=mesh, in_specs=P(("a", "b")), out_specs=P(("a", "b"))))
for dt in ("float32", "bfloat16"):
    y = fn(jnp.asarray(data["multi"]).astype(dt))
    out[f"multi/{dt}"] = np.asarray(y.astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def _bf16_exact(a):
    """float32 values that bfloat16 holds exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _tree_inputs():
    rng = np.random.default_rng(0)
    data = {}
    for spec in TREE_SPECS:
        a = Collectives().program(spec, kind="allgather").axis_size
        for k, shape in (("rs", (a, a * 3, 5)), ("ag", (a, 7, 3)),
                         ("ar", (a, 13, 7)), ("bc0", (a, 13, 7)),
                         ("bc3", (a, 9, 5)), ("rd0", (a, 13, 7)),
                         ("rd3", (a, 9, 5)), ("a2a", (a, a, 3, 5))):
            data[f"{spec}/{k}"] = _bf16_exact(
                rng.standard_normal(shape).astype(np.float32))
    data["multi"] = _bf16_exact(
        rng.standard_normal((4, 13, 7)).astype(np.float32))
    return data


@pytest.fixture(scope="module")
def tree_io(tmp_path_factory):
    """(inputs, JAX outputs) of every tree-collective case: the JAX side
    runs once, in a subprocess with 8 forced host devices."""
    d = tmp_path_factory.mktemp("tree")
    data = _tree_inputs()
    np.savez(d / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    cases = ";".join(f"{spec} {dt} {kinds}" for spec, dt, kinds in TREE_CASES)
    out = subprocess.run([sys.executable, "-c", JAX_TREE, str(d / "in.npz"),
                          str(d / "out.npz"), cases],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return data, dict(np.load(d / "out.npz"))


def _stacked_outputs(spec, dt, data, kinds="rs ag ar"):
    cc = Collectives()
    progs = {"rs": cc.program(spec, kind="reduce_scatter"),
             "ag": cc.program(spec, kind="allgather"),
             "ar": cc.program(spec, kind="allreduce"),
             "a2a": cc.program(spec, kind="alltoall", num_chunks=1)}
    for r in (0, 3):
        progs[f"bc{r}"] = cc.program(spec, kind="broadcast", root=r)
        progs[f"rd{r}"] = cc.program(spec, kind="reduce", root=r)
    comm = Stacked(progs["rs"].axis_size)
    fns = {"rs": tree_reduce_scatter, "ag": tree_all_gather,
           "ar": lambda v, pr, c: tree_all_reduce(v, *pr, c),
           "bc0": tree_broadcast, "bc3": tree_broadcast,
           "rd0": tree_reduce, "rd3": tree_reduce, "a2a": tree_all_to_all}
    out = {}
    for k in kinds.split():
        x = torch.from_numpy(data[f"{spec}/{k}"]).to(getattr(torch, dt))
        out[k] = fns[k](x, progs[k], comm)
    return out


@pytest.mark.parametrize("spec,dt,kinds", TREE_CASES)
def test_stacked_tree_collectives_bit_equal_jax(tree_io, spec, dt, kinds):
    """A reduce is compared on its root, where MPI_Reduce defines it."""
    data, ref = tree_io
    for k, y in _stacked_outputs(spec, dt, data, kinds).items():
        assert y.dtype == getattr(torch, dt)
        want = ref[f"{spec}/{dt}/{k}"]
        got = y.float().numpy()
        if k.startswith("rd"):
            root = int(k[2:])
            got, want = got[root], want[root]
            np.testing.assert_allclose(got, data[f"{spec}/{k}"].sum(0),
                                       rtol=0, atol=1e-5 if dt == "float32"
                                       else 0.1)
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_stacked_allreduce_close_to_the_sum():
    rs, ag = Collectives().program("dgx:8", kind="allreduce")
    x = torch.randn(8, 33, 5, generator=torch.Generator().manual_seed(1))
    y = tree_all_reduce(x, rs, ag, Stacked(8))
    for r in range(8):
        assert torch.equal(y[r], y[0])
    torch.testing.assert_close(y[0], x.sum(0), rtol=0, atol=1e-5)


def test_bucketed_and_compressed_allreduce_stacked():
    rs, ag = Collectives().program("bring:8", kind="allreduce")
    g = torch.Generator().manual_seed(2)
    grads = {"w1": torch.randn(8, 10, 3, generator=g),
             "w2": torch.randn(8, 50, generator=g),
             "n": torch.randn(8, 7, generator=g)}
    assert partition_buckets({k: v[0] for k, v in grads.items()}, 200) \
        == [["n"], ["w2"], ["w1"]]
    red = BucketedAllReduce(rs, ag, Stacked(8), bucket_bytes=200,
                            wire_dtype=None)
    out = red(grads)
    assert list(out) == list(grads)
    for k, v in grads.items():
        assert out[k].shape == v.shape
        torch.testing.assert_close(out[k][3], v.sum(0), rtol=0, atol=1e-5)
    # one bucket of all three gives the same sums
    whole = BucketedAllReduce(rs, ag, Stacked(8), wire_dtype=None)(grads)
    for k in grads:
        torch.testing.assert_close(whole[k], out[k], rtol=0, atol=1e-5)
    # bf16 on the wire: the payload is rounded to bf16, summed in f32 and
    # the reduced shard rounded to bf16 again (one bf16 ulp: 2**-8 relative)
    wired = BucketedAllReduce(rs, ag, Stacked(8), bucket_bytes=200)(grads)
    comp = compressed_all_reduce(grads["w2"], rs, ag, Stacked(8))
    torch.testing.assert_close(wired["w2"], comp, rtol=0, atol=0)
    ref = grads["w2"].bfloat16().float().sum(0)
    torch.testing.assert_close(comp[0], ref, rtol=2 ** -8, atol=1e-6)


# ---------------------------------------------------------------------- #
# P2P over gloo at world 4 vs the stacked form
# ---------------------------------------------------------------------- #

# the expert-parallel MoE layer that the P2P workers and the stacked form
# both build (same seed, same weights)
MOE_HELPERS = textwrap.dedent("""
    import torch

    def moe_config():
        from repro_torch.models.common import ModelConfig
        return ModelConfig(name="t", family="moe", num_layers=1, d_model=16,
                           num_heads=2, num_kv_heads=2, d_ff=32,
                           vocab_size=64, num_experts=8,
                           num_experts_per_tok=2, moe_d_ff=24,
                           num_shared_experts=1, capacity_factor=2.0)

    def moe_layer(cfg):
        from repro_torch.models import moe
        layer = moe.MoE(cfg)
        moe.init_moe(layer, cfg, torch.Generator().manual_seed(0))
        return layer
""")

P2P_SCRIPT = MOE_HELPERS + textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, port, inp, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", world_size=4, rank=rank,
                                init_method=f"tcp://localhost:{port}")
        import functools
        from repro_torch.api import Collectives
        from repro_torch.comms import (P2P, BucketedAllReduce,
                                       tree_all_gather, tree_all_reduce,
                                       tree_all_reduce_multi,
                                       tree_all_to_all, tree_broadcast,
                                       tree_reduce, tree_reduce_scatter)
        from repro_torch.models import moe
        data = np.load(inp)
        cc = Collectives()
        rs = cc.program("bring:4", kind="reduce_scatter")
        ag = cc.program("bring:4", kind="allgather")
        rs_ar, ag_ar = cc.program("bring:4", kind="allreduce")
        rs2, ag2 = cc.program("bring:2", kind="allreduce")
        a2a = cc.program("bring:4", kind="alltoall", num_chunks=1)
        rooted = {f"{k}{r}": (fn, cc.program("bring:4", kind=kind, root=r))
                  for k, fn, kind in (("bc", tree_broadcast, "broadcast"),
                                      ("rd", tree_reduce, "reduce"))
                  for r in (0, 3)}
        comm = P2P()
        # axis a: ranks with the same b index; axis b: the same a index
        ga = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        gb = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        i, j = divmod(rank, 2)
        multi = [(P2P(ga[j]), rs2, ag2), (P2P(gb[i]), rs2, ag2)]
        res = {}
        for dt in ("float32", "bfloat16"):
            x = {k: torch.from_numpy(data[f"bring:4/{k}"][rank]).to(
                getattr(torch, dt)) for k in ("rs", "ag", "ar")}
            res[f"{dt}/rs"] = tree_reduce_scatter(x["rs"], rs, comm)
            res[f"{dt}/ag"] = tree_all_gather(x["ag"], ag, comm)
            res[f"{dt}/ar"] = tree_all_reduce(x["ar"], rs_ar, ag_ar, comm)
            res[f"{dt}/multi"] = tree_all_reduce_multi(
                torch.from_numpy(data["multi"][rank]).to(getattr(torch, dt)),
                multi)
            for k, (fn, prog) in rooted.items():
                res[f"{dt}/{k}"] = fn(torch.from_numpy(
                    data[f"bring:4/{k}"][rank]).to(getattr(torch, dt)),
                    prog, comm)
            blocks = torch.from_numpy(data["bring:4/a2a"][rank]).to(
                getattr(torch, dt))
            res[f"{dt}/a2a"] = tree_all_to_all(blocks, a2a, comm)
            res[f"{dt}/a2a_single"] = torch.empty_like(blocks)
            dist.all_to_all_single(res[f"{dt}/a2a_single"], blocks)
        cfg = moe_config()
        layer = moe_layer(cfg)
        x = torch.from_numpy(data["moe_x"][rank])
        for tag, fn in (("plain", None), ("tree", functools.partial(
                tree_all_to_all, prog=a2a, comm=comm))):
            y, aux = moe.moe_forward_alltoall(layer, cfg, x, comm,
                                              all_to_all=fn)
            res[f"moe/{tag}/y"], res[f"moe/{tag}/aux"] = y, aux
        grads = {k: torch.from_numpy(data[f"grad/{k}"][rank])
                 for k in ("w1", "w2", "n")}
        for wire in ("none", "bfloat16"):
            red = BucketedAllReduce(rs_ar, ag_ar, comm, bucket_bytes=200,
                                    wire_dtype=None if wire == "none"
                                    else torch.bfloat16)
            for k, v in red(grads).items():
                res[f"bucket/{wire}/{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.detach().float().numpy() for k, v in res.items()})
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3]),
                 nprocs=4, join=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_p2p_gloo_world4_bit_equal_stacked(tree_io, tmp_path):
    data, ref = tree_io
    g = torch.Generator().manual_seed(3)
    grads = {"w1": torch.randn(4, 10, 3, generator=g),
             "w2": torch.randn(4, 50, generator=g),
             "n": torch.randn(4, 7, generator=g)}
    inputs = dict(data, **{f"grad/{k}": v.numpy() for k, v in grads.items()})
    inputs["moe_x"] = torch.randn(4, 2, 5, 16, generator=g).numpy()
    np.savez(tmp_path / "in.npz", **inputs)
    (tmp_path / "p2p.py").write_text(P2P_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "p2p.py"), str(_free_port()),
         str(tmp_path / "in.npz"), str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for dt in DTYPES:
        stacked = _stacked_outputs("bring:4", dt, data,
                                   "rs ag ar " + ROOTED)
        stacked["a2a_single"] = stacked["a2a"]
        for k, y in stacked.items():
            for r in range(4):
                np.testing.assert_array_equal(
                    ranks[r][f"{dt}/{k}"], y[r].float().numpy(),
                    err_msg=f"{dt}/{k} rank {r}")
        # two axes over process subgroups vs the JAX composition
        for r in range(4):
            np.testing.assert_array_equal(ranks[r][f"{dt}/multi"],
                                          ref[f"multi/{dt}"][r])
    # the expert-parallel MoE layer: under gloo the tree transport is
    # bit-equal to all_to_all_single, and both agree with the stacked form
    # to float32 rounding (a rank's matmuls have a quarter of the stacked
    # rows, so the CPU's BLAS may block them otherwise)
    mod = {}
    exec(MOE_HELPERS, mod)
    cfg = mod["moe_config"]()
    y, aux = tmoe.moe_forward_alltoall(mod["moe_layer"](cfg), cfg,
                                       torch.from_numpy(inputs["moe_x"]),
                                       Stacked(4))
    for r in range(4):
        for part, want in (("y", y[r]), ("aux", aux[r])):
            got = ranks[r][f"moe/plain/{part}"]
            np.testing.assert_array_equal(ranks[r][f"moe/tree/{part}"], got)
            np.testing.assert_allclose(got, want.detach().numpy(), rtol=0,
                                       atol=1e-6)
    rs_ar, ag_ar = Collectives().program("bring:4", kind="allreduce")
    for wire, wdt in (("none", None), ("bfloat16", torch.bfloat16)):
        red = BucketedAllReduce(rs_ar, ag_ar, Stacked(4), bucket_bytes=200,
                                wire_dtype=wdt)
        for k, y in red(grads).items():
            for r in range(4):
                np.testing.assert_array_equal(
                    ranks[r][f"bucket/{wire}/{k}"], y[r].numpy())
