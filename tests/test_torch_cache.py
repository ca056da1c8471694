"""The port's schedule artifact cache (`repro_torch.cache`) on the CPU:
fingerprints, exact JSON round trips, the on-disk cache (a hit skips the
compiler, a corrupt artifact is recompiled, LRU eviction), and every golden
artifact of tests/golden, byte-identical from the port's compiler copy and
through the port's serializer.  The counterparts of tests/test_cache.py
without its sweep tests (the zoo sweep, `cache/sweep.py`, is not
ported)."""
import json
import os
import time
from fractions import Fraction
from pathlib import Path

import pytest
import torch

from repro.api import Collectives as JaxCollectives
from repro.cache import serialize as jser
from repro_torch.api import Collectives
from repro_torch.cache import (FORMAT_VERSION, ScheduleCache,
                               allreduce_from_json, allreduce_to_json,
                               compiler_fingerprint, schedule_from_json,
                               schedule_to_json)
from repro_torch.cache import fingerprint as tfp
from repro_torch.core import (compile_allgather, compile_allreduce,
                              compile_alltoall, compile_broadcast,
                              compile_reduce, compile_reduce_scatter,
                              simulate_allgather, simulate_allreduce,
                              simulate_alltoall, simulate_broadcast,
                              simulate_reduce, simulate_reduce_scatter)
from repro_torch.core.graph import DiGraph
from repro_torch.topo import (bidir_ring, dragonfly, fig1a, hypercube, ring,
                              two_cluster_switch)

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "golden"


# ---------------------------------------------------------------------- #
# fingerprints
# ---------------------------------------------------------------------- #

def test_fingerprint_ignores_name_and_insertion_order():
    a = bidir_ring(6, name="a")
    b = bidir_ring(6, name="completely-different")
    assert a.fingerprint() == b.fingerprint()
    c = DiGraph(a.num_nodes, a.compute,
                dict(reversed(list(a.cap.items()))), "c")
    assert c.fingerprint() == a.fingerprint()


def test_fingerprint_sensitive_to_structure():
    base = bidir_ring(6)
    fps = {base.fingerprint(),
           bidir_ring(6, cap=2).fingerprint(),
           bidir_ring(7).fingerprint(),
           DiGraph(6, frozenset(range(5)), dict(base.cap)).fingerprint()}
    assert len(fps) == 4


def test_compiler_fingerprint_is_the_ports_own():
    """Stable, 16 hex digits, over the port's compiler copy: never the
    reference's, so the two packages' caches share no entry."""
    from repro.cache import compiler_fingerprint as jax_fp
    assert compiler_fingerprint() == compiler_fingerprint()
    assert len(compiler_fingerprint()) == 16
    assert compiler_fingerprint() != jax_fp()
    assert all(m.startswith("repro_torch.core.")
               for m in tfp._COMPILER_MODULES)
    assert FORMAT_VERSION == 3


def test_cache_keys_keep_the_reference_layout():
    from repro.cache import fingerprint as jfp
    from repro.topo import fig1a as jax_fig1a
    from repro.topo.spec import TransformSpec as JaxTransform
    from repro_torch.topo.spec import TransformSpec
    g, jg = fig1a(), jax_fig1a()
    assert tfp.schedule_cache_key("broadcast", g, 8, root=2,
                                  compiler_fp="c") == \
        jfp.schedule_cache_key("broadcast", jg, 8, root=2, compiler_fp="c")
    tr = "@degrade(0-9,cap=5)"
    assert tfp.repair_cache_key("allreduce", g, TransformSpec.parse_text(tr),
                                4, compiler_fp="c") == \
        jfp.repair_cache_key("allreduce", jg, JaxTransform.parse_text(tr), 4,
                             compiler_fp="c")


# ---------------------------------------------------------------------- #
# exact round trips
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("make,p", [
    (fig1a, 8), (lambda: ring(6), 4), (lambda: bidir_ring(5), 4),
    (dragonfly, 4), (lambda: hypercube(3), 4),
])
def test_schedule_roundtrip_exact(make, p):
    sched = compile_allgather(make(), num_chunks=p)
    text = schedule_to_json(sched)
    back = schedule_from_json(text)
    assert schedule_to_json(back) == text
    assert isinstance(back.opt.inv_x_star, Fraction)
    assert back.opt == sched.opt
    assert back.claimed_runtime == sched.claimed_runtime
    assert back.rounds == sched.rounds
    assert back.path_assignment == sched.path_assignment
    assert back.topo.cap == sched.topo.cap
    assert [(c.root, c.mult, c.verts, c.edges) for c in back.classes] == \
        [(c.root, c.mult, c.verts, c.edges) for c in sched.classes]
    assert simulate_allgather(back).sim_time == back.claimed_runtime


def test_allreduce_and_reduce_scatter_roundtrip_exact():
    ar = compile_allreduce(dragonfly(), num_chunks=4)
    text = allreduce_to_json(ar)
    back = allreduce_from_json(text)
    assert allreduce_to_json(back) == text
    assert simulate_allreduce(back).sim_time == back.claimed_runtime
    rs = compile_reduce_scatter(fig1a(), num_chunks=4)
    back = schedule_from_json(schedule_to_json(rs))
    assert simulate_reduce_scatter(back).sim_time == back.claimed_runtime


@pytest.mark.parametrize("compiler,simulator", [
    (compile_broadcast, simulate_broadcast),
    (compile_reduce, simulate_reduce)])
def test_rooted_roundtrip_exact(compiler, simulator):
    for make, root in ((fig1a, 2), (lambda: bidir_ring(6), 0)):
        sched = compiler(make(), root=root, num_chunks=4)
        text = schedule_to_json(sched)
        back = schedule_from_json(text)
        assert schedule_to_json(back) == text
        assert back.root == root and json.loads(text)["root"] == root
        assert simulator(back).sim_time == back.claimed_runtime


# ---------------------------------------------------------------------- #
# the on-disk cache
# ---------------------------------------------------------------------- #

def test_cache_hit_skips_compiler(tmp_path, monkeypatch):
    ScheduleCache(tmp_path).allgather(bidir_ring(5), num_chunks=4)

    def boom(*a, **kw):                                    # pragma: no cover
        raise AssertionError("compiler invoked on cache hit")

    monkeypatch.setattr("repro_torch.core.schedule.compile_allgather", boom)
    fresh = ScheduleCache(tmp_path)
    sched = fresh.allgather(bidir_ring(5, name="renamed"), num_chunks=4)
    assert fresh.stats.hits == 1 and fresh.stats.misses == 0
    assert simulate_allgather(sched).sim_time == sched.claimed_runtime


def test_facade_pair_and_programs_hit_the_cache(tmp_path, monkeypatch):
    """Collectives(cache=path): a second facade on the same directory
    replays the family and lowers the same programs without compiling."""
    from repro_torch.comms import compile_program

    def programs():
        coll = Collectives(cache=tmp_path, num_chunks=4)
        ag, rs = coll.pair(ring(4))
        return coll, compile_program(rs), compile_program(ag)

    _, rs1, ag1 = programs()
    monkeypatch.setattr("repro_torch.core.schedule.compile_allgather",
                        lambda *a, **kw: pytest.fail("compiler on hit path"))
    monkeypatch.setattr("repro_torch.core.plan.compile_family",
                        lambda *a, **kw: pytest.fail("compiler on hit path"))
    coll, rs2, ag2 = programs()
    assert coll.cache.stats.hits == 2 and coll.cache.stats.misses == 0

    def sig(prog):
        return [(c.perm, c.width, c.send_slots.tolist(),
                 c.recv_slots.tolist()) for rnd in prog.rounds for c in rnd]
    assert sig(rs1) == sig(rs2) and sig(ag1) == sig(ag2)
    assert "hits=2 misses=0" in coll.describe()


def test_cache_distinguishes_params(tmp_path):
    c = ScheduleCache(tmp_path)
    c.allgather(ring(4), num_chunks=4)
    c.allgather(ring(4), num_chunks=8)
    c.allgather(ring(5), num_chunks=4)
    assert c.stats.misses == 3 and len(c.entries()) == 3
    c.allgather(ring(4), num_chunks=4)
    assert c.stats.hits == 1


def test_cache_compiler_version_invalidates(tmp_path):
    ScheduleCache(tmp_path, compiler_fp="deadbeef00000000").allgather(
        ring(4), num_chunks=4)
    new = ScheduleCache(tmp_path)
    new.allgather(ring(4), num_chunks=4)
    assert new.stats.misses == 1
    assert len(new.entries()) == 2
    assert new.prune_stale() == 1
    assert len(new.entries()) == 1


def test_cache_recovers_from_corrupt_artifact(tmp_path):
    c = ScheduleCache(tmp_path)
    sched = c.allgather(ring(4), num_chunks=4)
    c.path_for(c.key("allgather", ring(4), 4)).write_text(
        '{"format": "repro.schedule", "vers')               # torn write
    fresh = ScheduleCache(tmp_path)
    with pytest.warns(UserWarning, match="unreadable schedule artifact"):
        again = fresh.allgather(ring(4), num_chunks=4)
    assert fresh.stats.misses == 1 and fresh.stats.puts == 1
    assert again.rounds == sched.rounds


def test_cache_allreduce_rooted_and_alltoall_kinds(tmp_path):
    c = ScheduleCache(tmp_path)
    ar = c.allreduce(dragonfly(), num_chunks=4)
    bc = c.broadcast(bidir_ring(6), root=2, num_chunks=4)
    red = c.reduce(fig1a(), root=1, num_chunks=4)
    a2a = c.alltoall(fig1a(), num_chunks=1)
    c2 = ScheduleCache(tmp_path)
    assert c2.allreduce(dragonfly(), num_chunks=4).claimed_runtime == \
        ar.claimed_runtime
    assert c2.broadcast(bidir_ring(6), root=2, num_chunks=4).rounds == \
        bc.rounds
    again = c2.reduce(fig1a(), root=1, num_chunks=4)
    assert again.kind == "reduce" and again.root == 1
    assert simulate_reduce(again).sim_time == red.claimed_runtime
    assert simulate_alltoall(c2.alltoall(fig1a(), num_chunks=1)).sim_time \
        == a2a.claimed_runtime
    assert c2.stats.hits == 4 and c2.stats.misses == 0
    c2.broadcast(bidir_ring(6), root=0, num_chunks=4)   # another root
    assert c2.stats.misses == 1


def test_cache_family_shares_keys_with_per_kind(tmp_path):
    timings = {}
    fam = ScheduleCache(tmp_path).family(
        fig1a(), ("allgather", "reduce_scatter", "allreduce"), num_chunks=4,
        timings=timings)
    assert set(timings) == set(fam)
    c = ScheduleCache(tmp_path)
    assert schedule_to_json(c.allgather(fig1a(), num_chunks=4)) == \
        schedule_to_json(fam["allgather"])
    assert allreduce_to_json(c.allreduce(fig1a(), num_chunks=4)) == \
        allreduce_to_json(fam["allreduce"])
    assert c.stats.misses == 0


def test_cache_lru_eviction(tmp_path):
    sizes = {}
    for n in (4, 5, 6):
        probe = ScheduleCache(tmp_path / f"probe{n}")
        probe.allgather(ring(n), num_chunks=4)
        sizes[n] = probe.size_bytes()
    cap = sizes[4] + sizes[6] + sizes[5] // 2
    c = ScheduleCache(tmp_path / "lru", max_bytes=cap)
    c.allgather(ring(4), num_chunks=4)
    c.allgather(ring(5), num_chunks=4)
    assert c.stats.evictions == 0
    for p in sorted((tmp_path / "lru").glob("*.json")):
        os.utime(p, (time.time() - 60, time.time() - 60))
    hot = ScheduleCache(tmp_path / "lru", max_bytes=cap)
    hot.allgather(ring(4), num_chunks=4)            # refreshes recency
    assert hot.stats.hits == 1
    hot.allgather(ring(6), num_chunks=4)            # over the cap
    assert hot.stats.evictions == 1
    keys = "".join(hot.entries())
    assert hot.key("allgather", ring(4), 4) in keys
    assert hot.key("allgather", ring(5), 4) not in keys
    assert ScheduleCache(tmp_path / "lru").allgather(
        ring(4), num_chunks=4).claimed_runtime is not None


def test_cache_lru_refresh_on_memory_hit(tmp_path):
    c = ScheduleCache(tmp_path, max_bytes=1 << 30)
    c.allgather(ring(4), num_chunks=4)
    path = c.path_for(c.key("allgather", ring(4), 4))
    os.utime(path, (time.time() - 3600, time.time() - 3600))
    stale = path.stat().st_mtime
    c.allgather(ring(4), num_chunks=4)              # memory hit
    assert c.stats.hits == 1
    assert path.stat().st_mtime > stale


def test_cache_index_and_sidecars(tmp_path):
    c = ScheduleCache(tmp_path)
    c.allreduce(fig1a(), num_chunks=4)
    key = c.key("allreduce", fig1a(), 4)
    assert set(c.index()) == {key}
    assert c.stats_path_for(key).exists()
    c.stats_path_for(key).unlink()
    c._index_path().unlink()
    assert set(c.rebuild_index()) == {key}
    again = ScheduleCache(tmp_path).allreduce(fig1a(), num_chunks=4)
    assert again.rs.compile_stats is None      # no sidecar, still a hit
    c.clear()
    assert c.entries() == [] and c.index() == {}


def test_default_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    from repro_torch.cache import default_cache_dir
    monkeypatch.delenv("REPRO_TORCH_SCHEDULE_CACHE", raising=False)
    assert "repro_torch" in default_cache_dir()
    monkeypatch.setenv("REPRO_TORCH_SCHEDULE_CACHE", str(tmp_path))
    assert default_cache_dir() == str(tmp_path)


# ---------------------------------------------------------------------- #
# goldens: byte-identical through the port
# ---------------------------------------------------------------------- #

# (file, topology, compiler, simulator): the 7 artifacts of tests/golden
GOLDENS = [
    ("fig1a.allgather.p8.json", fig1a,
     lambda g: compile_allgather(g, num_chunks=8), simulate_allgather),
    ("bring8.allgather.p8.json", lambda: bidir_ring(8),
     lambda g: compile_allgather(g, num_chunks=8), simulate_allgather),
    ("two_cluster_3x6.allgather.p8.json",
     lambda: two_cluster_switch(3, 6, 2),
     lambda g: compile_allgather(g, num_chunks=8), simulate_allgather),
    ("fig1a.broadcast.r0.p8.json", fig1a,
     lambda g: compile_broadcast(g, root=0, num_chunks=8),
     simulate_broadcast),
    ("bring8.reduce.r0.p8.json", lambda: bidir_ring(8),
     lambda g: compile_reduce(g, root=0, num_chunks=8), simulate_reduce),
    ("fig1a.alltoall.p1.json", fig1a,
     lambda g: compile_alltoall(g, num_chunks=1), simulate_alltoall),
    ("dragonfly.allreduce.p8.json", dragonfly,
     lambda g: compile_allreduce(g, num_chunks=8), simulate_allreduce),
]


def _dumps(art):
    return allreduce_to_json(art) if hasattr(art, "rs") \
        else schedule_to_json(art)


def _loads(fname, text):
    return allreduce_from_json(text) if ".allreduce." in fname \
        else schedule_from_json(text)


@pytest.mark.parametrize("fname,make,compiler,simulator", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_golden_is_byte_identical_through_the_port(fname, make, compiler,
                                                   simulator):
    text = (GOLDEN_DIR / fname).read_text()
    # the port's serializer round-trips the checked-in bytes
    art = _loads(fname, text)
    assert _dumps(art) == text
    assert simulator(art).sim_time == art.claimed_runtime
    assert art.topo.fingerprint() == make().fingerprint()
    # the port's compiler emits them
    assert _dumps(compiler(make())) == text


@pytest.mark.parametrize("fname,make,compiler,simulator", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_golden_replays_byte_identical_from_the_ports_cache(
        tmp_path, fname, make, compiler, simulator):
    """Stored and reloaded by the port's cache, each golden artifact keeps
    its bytes, and the payload equals the reference serializer's."""
    text = (GOLDEN_DIR / fname).read_text()
    art = _loads(fname, text)
    c = ScheduleCache(tmp_path)
    kind, num_chunks, root = ScheduleCache.artifact_meta(art)
    key = c.key(kind, art.topo, num_chunks, root=root)
    c._store(key, art)
    assert c.path_for(key).read_text() == text
    back = ScheduleCache(tmp_path)._load(key, allreduce=hasattr(art, "rs"))
    assert _dumps(back) == text
    jart = jser.allreduce_from_json(text) if hasattr(art, "rs") \
        else jser.schedule_from_json(text)
    jtext = jser.allreduce_to_json(jart) if hasattr(art, "rs") \
        else jser.schedule_to_json(jart)
    assert jtext == text


def test_facade_cache_payloads_equal_the_reference_facades(tmp_path):
    """The same request through both facades' caches writes the same
    artifact bytes (the file names differ only in the compiler
    fingerprint)."""
    for spec, opts in (("dgx:8", dict(kind="allreduce")),
                       ("fig1a", dict(kind="broadcast", root=0))):
        t = Collectives(cache=tmp_path / "t", num_chunks=8)
        j = JaxCollectives(cache=tmp_path / "j", num_chunks=8)
        t.schedule(spec, **opts)
        j.schedule(spec, **opts)
        (tf,), (jf,) = (sorted((tmp_path / d).glob(f"{opts['kind']}-*.json"))
                        for d in ("t", "j"))
        assert tf.read_bytes() == jf.read_bytes()
        assert tf.name.rsplit("-", 1)[0] == jf.name.rsplit("-", 1)[0]
