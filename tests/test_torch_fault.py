"""Training's state and recovery in the port, on the CPU: online schedule
repair (`Collectives.repair`) held byte for byte against the JAX package's,
its cache sidecars, `CollectiveContext.hot_swap`, checkpoints, the
fault-tolerant supervisor (with a stress test of the checkpoint pointer
race the port's checkpoint must not have), and the gloo launch with an
injected link fault and a schedule cache."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import Collectives as JaxCollectives
from repro.cache import serialize as jser
from repro.cache.sweep import LARGE_NAMES
from repro_torch.api import Collectives
from repro_torch.cache import allreduce_to_json, schedule_to_json
from repro_torch.comms import CollectiveContext, Stacked
from repro_torch.configs import reduced_config
from repro_torch.core.repair import RepairError
from repro_torch.models import build_model
from repro_torch.topo.spec import TopologySpec, TransformSpec, zoo_specs
from repro_torch.topo.zoo import fail_link
from repro_torch.train import (AdamWState, FaultInjector, LinkFault,
                               StragglerMonitor, TrainSupervisor, checkpoint,
                               elastic_plan, init_train_state)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL = 1e-5


# ---------------------------------------------------------------------- #
# Collectives.repair against the reference, byte for byte
# ---------------------------------------------------------------------- #

def _symmetric_links(g):
    return sorted((u, v) for (u, v), c in g.cap.items()
                  if u < v and g.cap.get((v, u)) == c)


def _connected(g):
    nodes = {u for e in g.cap for u in e} | set(g.compute)
    fwd, rev = {}, {}
    for (u, v) in g.cap:
        fwd.setdefault(u, []).append(v)
        rev.setdefault(v, []).append(u)

    def reach(adj):
        seen, stack = {min(nodes)}, [min(nodes)]
        while stack:
            for y in adj.get(stack.pop(), ()):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen
    return nodes <= reach(fwd) and nodes <= reach(rev)


def pick_fail(g):
    """The first link whose loss keeps the fabric Eulerian and connected."""
    for u, v in _symmetric_links(g):
        try:
            if _connected(fail_link(g, u, v)):
                return f"@fail({u}-{v})"
        except ValueError:
            continue
    return None


def pick_degrade(g):
    """The first link with capacity to lose, degraded by one unit."""
    for u, v in _symmetric_links(g):
        if g.cap[(u, v)] >= 2:
            return f"@degrade({u}-{v},cap={g.cap[(u, v)] - 1})"
    return None


REPAIR_CASES = [(name, tr)
                for name in sorted(n for n in zoo_specs()
                                   if n not in LARGE_NAMES)
                for picker in (pick_fail, pick_degrade)
                for tr in [picker(zoo_specs()[name].build())]
                if tr is not None]


def _report_fields(r):
    d = r.to_dict()
    return {k: v for k, v in d.items() if not k.endswith("_time_s")}


@pytest.mark.parametrize("name,tr", REPAIR_CASES,
                         ids=[f"{n}{t}" for n, t in REPAIR_CASES])
def test_repair_equals_the_reference_byte_for_byte(name, tr):
    got, rep = Collectives(num_chunks=4).repair(name, tr)
    ref, jrep = JaxCollectives(num_chunks=4).repair(name, tr)
    assert schedule_to_json(got) == jser.schedule_to_json(ref)
    assert _report_fields(rep) == _report_fields(jrep)
    assert rep.verified


@pytest.mark.parametrize("spec,tr", [("fig1a", "@fail(0-9)"),
                                     ("bring:8,cap=2", "@degrade(0-1,cap=1)"),
                                     ("dgx:8", "@fail(0-1)"),
                                     ("multipod:2x4", "@degrade(0-9,cap=5)")])
def test_allreduce_and_rooted_repair_equal_the_reference(spec, tr):
    for opts in (dict(kind="allreduce"), dict(kind="broadcast", root=0),
                 dict(kind="reduce_scatter")):
        got, _ = Collectives(num_chunks=4).repair(spec, tr, **opts)
        ref, _ = JaxCollectives(num_chunks=4).repair(spec, tr, **opts)
        dump = allreduce_to_json if opts["kind"] == "allreduce" \
            else schedule_to_json
        jdump = jser.allreduce_to_json if opts["kind"] == "allreduce" \
            else jser.schedule_to_json
        assert dump(got) == jdump(ref)


def test_repaired_artifact_equals_a_cold_compile():
    coll = Collectives(num_chunks=4)
    tr = "@fail(0-9)"
    rep, report = coll.repair(coll.schedule("fig1a", kind="allreduce"), tr)
    cold = coll.schedule(TransformSpec.parse_text(tr).apply(
        coll.topology("fig1a")), kind="allreduce")
    assert allreduce_to_json(rep) == allreduce_to_json(cold)
    assert report.kind == "allreduce" and report.verified


def test_repair_errors():
    with pytest.raises(RepairError, match="automatic k"):
        coll = Collectives(num_chunks=4, fixed_k=2)
        coll.repair(coll.schedule("bring:8,cap=2"), "@degrade(0-1,cap=1)")
    coll = Collectives(num_chunks=1)
    with pytest.raises(RepairError, match="alltoall"):
        coll.repair(coll.schedule("fig1a", kind="alltoall"), "@fail(0-9)")
    with pytest.raises(RepairError, match="alltoall"):
        coll.repair("fig1a", "@fail(0-9)", kind="alltoall")
    with pytest.raises(RepairError, match="does not apply"):
        Collectives(num_chunks=4).repair("fig1a", "@fail(90-91)")


def test_repair_sidecar_replay(tmp_path):
    coll = Collectives(cache=tmp_path, num_chunks=4)
    tr = "@degrade(0-9,cap=5)"
    art = coll.schedule("fig1a")
    rep1, r1 = coll.repair(art, tr)
    assert not r1.cached
    (sidecar,) = tmp_path.glob("*.repair")
    doc = json.loads(sidecar.read_text())
    assert doc["format"] == "repro.repair" and doc["transform"] == tr
    assert doc["base_fingerprint"] == art.topo.fingerprint()
    # the same (base, transform) replays: cached, original wall time
    rep2, r2 = coll.repair(art, tr)
    assert r2.cached and r2.repair_time_s == r1.repair_time_s
    assert schedule_to_json(rep2) == schedule_to_json(rep1)
    # the artifact sits under the degraded topology's own key
    direct = Collectives(cache=tmp_path, num_chunks=4).schedule(
        f"fig1a{tr}")
    assert schedule_to_json(direct) == schedule_to_json(rep1)


def test_repair_dangling_sidecar_is_a_miss_and_clear_removes_it(tmp_path):
    coll = Collectives(cache=tmp_path, num_chunks=4)
    art = coll.schedule("fig1a")
    rep1, _ = coll.repair(art, "@fail(0-9)")
    doc = json.loads(next(tmp_path.glob("*.repair")).read_text())
    (tmp_path / f"{doc['artifact_key']}.json").unlink()
    coll2 = Collectives(cache=tmp_path, num_chunks=4)
    rep2, r2 = coll2.repair(art, "@fail(0-9)")
    assert not r2.cached
    assert schedule_to_json(rep2) == schedule_to_json(rep1)
    coll2.cache.clear()
    assert not list(tmp_path.glob("*.repair"))
    assert not list(tmp_path.glob("*.json"))


# ---------------------------------------------------------------------- #
# hot swap
# ---------------------------------------------------------------------- #

def test_hot_swap_repairs_every_compiled_program():
    coll = Collectives(num_chunks=4)
    ctx = CollectiveContext({"data": 8, "model": 1},
                            topologies={"data": "bring:8,cap=2"},
                            collectives=coll)
    ctx.axis("data")
    ctx.allreduce_schedule("data")
    ctx.broadcast_program("data", root=0)
    reports = ctx.hot_swap("@degrade(0-1,cap=1)")
    assert set(reports) == {"data"}
    assert sorted(r.kind for r in reports["data"]) == \
        ["allgather", "allreduce", "broadcast", "reduce_scatter"]
    deg = TransformSpec.parse_text("@degrade(0-1,cap=1)").apply(
        TopologySpec.parse("bring:8,cap=2").build())
    assert ctx.topology("data").cap[(0, 1)] == 1
    assert schedule_to_json(ctx.axis("data").ag_sched) == \
        schedule_to_json(coll.schedule(deg, kind="allgather"))
    assert allreduce_to_json(ctx.allreduce_schedule("data")) == \
        allreduce_to_json(coll.schedule(deg, kind="allreduce"))
    prog = ctx.broadcast_program("data", root=0)
    assert prog.describe() == coll.program(deg, kind="broadcast",
                                           root=0).describe()


def test_hot_swap_leaves_untouched_axes_and_is_atomic():
    ctx = CollectiveContext({"data": 8, "pod": 4},
                            topologies={"data": "bring:8,cap=2",
                                        "pod": "bring:4"},
                            collectives=Collectives(num_chunks=4))
    before = schedule_to_json(ctx.axis("data").ag_sched)
    pod = schedule_to_json(ctx.axis("pod").ag_sched)
    with pytest.raises(ValueError, match="applies to no axis"):
        ctx.hot_swap("@fail(90-91)")
    with pytest.raises(ValueError, match="names no link"):
        ctx.hot_swap("@fail(3)")
    # a fault that disconnects the ring raises mid-repair: nothing swapped
    with pytest.raises((ValueError, RepairError)):
        ctx.hot_swap("@degrade(0-1,cap=0)")
    assert schedule_to_json(ctx.axis("data").ag_sched) == before
    assert ctx.topology("data").cap[(0, 1)] == 2
    # link 4-5 exists only on the data ring: the pod axis is left alone
    reports = ctx.hot_swap("@degrade(4-5,cap=1)")
    assert set(reports) == {"data"}
    assert schedule_to_json(ctx.axis("pod").ag_sched) == pod
    assert schedule_to_json(ctx.axis("data").ag_sched) != before


def test_hot_swap_refuses_an_axis_holding_alltoall_before_any_swap():
    ctx = CollectiveContext({"data": 8}, collectives=Collectives(num_chunks=4))
    before = schedule_to_json(ctx.axis("data").ag_sched)
    ctx.alltoall_program("data")
    with pytest.raises(RepairError, match="alltoall"):
        ctx.hot_swap("@fail(0-1)")
    assert schedule_to_json(ctx.axis("data").ag_sched) == before


def test_hot_swap_then_rebuilt_hook_equals_a_cold_degraded_context():
    """Stacked ranks: the hook built after the swap runs the repaired
    programs, bit-equal to a context built cold on the degraded ring; the
    hook built before keeps its own programs."""
    gen = torch.Generator().manual_seed(0)
    stack = torch.randn(8, 5000, generator=gen)
    ctx = CollectiveContext({"data": 8})
    old = ctx.bucketed_allreduce("data", Stacked(8), wire_dtype=None)
    before = old.reduce_bucket(stack)
    degraded = TransformSpec.parse_text("@fail(0-1)").apply(
        ctx.topology("data"))
    ctx.hot_swap("@fail(0-1)")
    new = ctx.bucketed_allreduce("data", Stacked(8), wire_dtype=None)
    assert new.rs_prog is not old.rs_prog
    cold = CollectiveContext({"data": 8}, topologies={"data": degraded})
    ref = cold.bucketed_allreduce("data", Stacked(8),
                                  wire_dtype=None).reduce_bucket(stack)
    got = new.reduce_bucket(stack)
    assert torch.equal(got, ref)
    torch.testing.assert_close(got, stack.sum(0).expand(8, -1), rtol=0,
                               atol=1e-4)
    assert torch.equal(old.reduce_bucket(stack), before)


def test_context_reports_stats_and_its_cache(tmp_path):
    ctx = CollectiveContext({"data": 4},
                            collectives=Collectives(cache=tmp_path))
    assert "nothing compiled yet" in ctx.compile_stats_report()
    ctx.allreduce_schedule("data")
    assert "data.allreduce" in ctx.compile_stats_report()
    assert ctx.schedule_cache is ctx.collectives.cache
    ctx2 = CollectiveContext({"data": 4},
                             collectives=Collectives(cache=tmp_path))
    ctx2.allreduce_schedule("data")
    assert "hits=1 misses=0" in ctx2.schedule_cache.describe()
    # the stage times of the original compile come back from the sidecar
    assert "data.allreduce" in ctx2.compile_stats_report()


# ---------------------------------------------------------------------- #
# checkpoints
# ---------------------------------------------------------------------- #

@pytest.fixture
def train_state():
    model = build_model(reduced_config("qwen3-8b"))
    params, opt = init_train_state(model, 0, "cpu")
    with torch.no_grad():
        for n in opt.mu:
            opt.mu[n].normal_()
            opt.nu[n].uniform_()
    return model, (params, AdamWState(7, opt.mu, opt.nu))


def test_checkpoint_roundtrip_names_and_gc(tmp_path, train_state):
    model, state = train_state
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        checkpoint.save(d, s, state)
    checkpoint.gc_old(d, keep=2)
    assert checkpoint.all_steps(d) == [3, 4]
    man = json.loads((tmp_path / "step_000000004" / "manifest.json")
                     .read_text())
    names = list(man["leaves"])
    assert names[0].startswith("params/") and "opt/step" in names
    assert any(n.startswith("opt/mu/") for n in names)
    assert any(n.startswith("opt/nu/") for n in names)
    assert man["leaves"]["opt/mu/embed"]["dtype"] == "float32"
    fresh = init_train_state(model, 1, "cpu")
    (p2, o2), step = checkpoint.restore(d, fresh)
    assert step == 4 and o2.step == 7 and p2 is fresh[0]
    for a, b in zip(state[0].parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for n in state[1].mu:
        assert torch.equal(state[1].mu[n], o2.mu[n])
        assert torch.equal(state[1].nu[n], o2.nu[n])


def test_checkpoint_restore_validates_shape_and_dtype(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"w": torch.ones(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), {"w": torch.ones(4, 3)})
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.restore(str(tmp_path),
                           {"w": torch.ones(3, 4, dtype=torch.float64)})
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(str(tmp_path), {"v": torch.ones(3, 4)})
    with pytest.raises(TypeError, match="bfloat16"):
        checkpoint.save(str(tmp_path), 2,
                        {"w": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), {"w": torch.ones(1)})


def test_save_async_copies_before_the_state_moves_on(tmp_path):
    w = torch.zeros(1000)
    checkpoint.save_async(str(tmp_path), 1, {"w": w})
    w.add_(1.0)                      # the in-place optimizer goes on at once
    checkpoint.wait_pending()
    state, step = checkpoint.restore(str(tmp_path), {"w": torch.empty(1000)})
    assert step == 1 and torch.equal(state["w"], torch.zeros(1000))


def test_latest_never_moves_back_and_gc_keeps_it(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 6, {"n": torch.tensor(6.0)})
    checkpoint.save(d, 3, {"n": torch.tensor(3.0)})   # a late older writer
    assert checkpoint.latest_step(d) == 6
    checkpoint.save(d, 6, {"n": torch.tensor(60.0)})  # the step saved again
    assert checkpoint.restore(d, {"n": torch.zeros(())})[0]["n"] == 60.0
    checkpoint.save(d, 9, {"n": torch.tensor(9.0)})
    assert checkpoint.latest_step(d) == 9
    checkpoint.gc_old(d, keep=1)
    assert checkpoint.all_steps(d) == [9]
    assert not [f for f in os.listdir(d) if ".tmp" in f or ".old" in f]


def test_concurrent_writers_leave_latest_at_the_largest_step(tmp_path):
    """40 writer threads in a shuffled order, with the interpreter switching
    threads as often as it can: LATEST ends at the largest step."""
    d = str(tmp_path)
    steps = list(np.random.default_rng(0).permutation(np.arange(1, 41)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [checkpoint.save_async(d, int(s),
                                         {"n": torch.tensor(float(s))})
                   for s in steps]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        checkpoint.wait_pending()
    finally:
        sys.setswitchinterval(interval)
    assert checkpoint.latest_step(d) == 40
    assert checkpoint.all_steps(d) == list(range(1, 41))


def test_writer_errors_reach_wait_pending(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.np, "savez", broken)
    checkpoint.save_async(str(tmp_path), 1, {"n": torch.zeros(())})
    with pytest.raises(OSError, match="disk full"):
        checkpoint.wait_pending()
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert not [f for f in os.listdir(tmp_path) if f.startswith("step_")]


# ---------------------------------------------------------------------- #
# the supervisor
# ---------------------------------------------------------------------- #

def _counting_run(d, crash_at=7, num_steps=10, ckpt_every=3):
    seen = []

    def step_fn(step, state):
        seen.append(step)
        if step == crash_at and seen.count(crash_at) == 1:
            raise RuntimeError("injected crash")
        return {"n": state["n"] + 1}, {"loss": torch.tensor(float(step))}

    sup = TrainSupervisor(ckpt_dir=d, ckpt_every=ckpt_every, max_restarts=1)
    state, final = sup.run(state={"n": torch.zeros(())},
                           num_steps=num_steps, step_fn=step_fn,
                           log=lambda s: None)
    return seen, state, final


def test_supervisor_crash_restores_the_last_checkpoint(tmp_path):
    seen, state, final = _counting_run(str(tmp_path))
    assert final == 10
    assert seen == [0, 1, 2, 3, 4, 5, 6, 7, 6, 7, 8, 9]
    assert int(state["n"]) == 10


def test_supervisor_restore_stress_against_the_pointer_race(tmp_path,
                                                            monkeypatch):
    """50 runs, each with a checkpoint every 3 steps and a crash at step 7,
    and the writer of step 3 slowed so that it lands after the writer of
    step 6: LATEST must still name step 6, so every run replays exactly
    6..9."""
    savez = np.savez

    def slow_for_step3(path, **arrays):
        if "step_000000003" in str(path):
            import time
            time.sleep(0.02)
        return savez(path, **arrays)
    monkeypatch.setattr(checkpoint.np, "savez", slow_for_step3)
    for run in range(50):
        d = str(tmp_path / f"run{run}")
        seen, state, final = _counting_run(d)
        assert seen == [0, 1, 2, 3, 4, 5, 6, 7, 6, 7, 8, 9], (run, seen)
        assert final == 10 and int(state["n"]) == 10
        assert checkpoint.latest_step(d) == 10


def test_supervisor_crash_budget_and_first_checkpoint(tmp_path):
    def crashing(step, state):
        raise RuntimeError("always")
    sup = TrainSupervisor(ckpt_dir=str(tmp_path / "a"), max_restarts=2)
    with pytest.raises(RuntimeError, match="failure before first"):
        sup.run(state={"n": torch.zeros(())}, num_steps=3,
                step_fn=crashing, log=lambda s: None)

    def late(step, state):
        if step >= 2:
            raise RuntimeError("always")
        return state, {}
    sup = TrainSupervisor(ckpt_dir=str(tmp_path / "b"), ckpt_every=1,
                          max_restarts=2)
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        sup.run(state={"n": torch.zeros(())}, num_steps=4, step_fn=late,
                log=lambda s: None)


def test_supervisor_link_fault_retries_the_same_step(tmp_path):
    inj = FaultInjector.parse("4:2-3")
    seen, hooked = [], []

    def step_fn(step, state):
        inj.check(step)
        seen.append(step)
        return {"n": state["n"] + 1}, {}

    sup = TrainSupervisor(ckpt_dir=str(tmp_path), ckpt_every=100,
                          on_link_fault=hooked.append)
    state, final = sup.run(state={"n": torch.zeros(())}, num_steps=8,
                           step_fn=step_fn, log=lambda s: None)
    assert final == 8 and seen == list(range(8)) and int(state["n"]) == 8
    assert len(hooked) == 1 and isinstance(hooked[0], LinkFault)
    assert hooked[0].transform_text == "@fail(2-3)"


def test_supervisor_link_fault_budget_and_no_hook(tmp_path):
    def always_faulting(step, state):
        raise LinkFault(0, 1)
    sup = TrainSupervisor(ckpt_dir=str(tmp_path),
                          on_link_fault=lambda e: None, max_link_faults=2)
    with pytest.raises(RuntimeError, match="exceeded 2 link faults"):
        sup.run(state={"n": torch.zeros(())}, num_steps=4,
                step_fn=always_faulting, log=lambda s: None)
    with pytest.raises(LinkFault):
        TrainSupervisor(ckpt_dir=str(tmp_path)).run(
            state={"n": torch.zeros(())}, num_steps=4,
            step_fn=always_faulting, log=lambda s: None)


def test_fault_injector_straggler_monitor_and_elastic_plan():
    inj = FaultInjector.parse("3:0-12")
    assert (inj.at_step, inj.u, inj.v) == (3, 0, 12)
    for bad in ("", "3", "0-1", "a:0-1", "3:01", "3:a-b"):
        with pytest.raises(ValueError):
            FaultInjector.parse(bad)
    m = StragglerMonitor()
    for i in range(10):
        assert not m.observe(i, 1.0)
    flags = [m.observe(10 + i, 5.0) for i in range(60)]
    assert flags[0] and not any(flags[-20:])
    assert m.ewma == pytest.approx(5.0, rel=0.05)
    plan = elastic_plan(old_devices=256, new_devices=240, global_batch=256,
                        model_parallel=16)
    assert plan["mesh_shape"] == (15, 16)
    assert (256 * plan["microbatch_scale"]) % 15 == 0
    with pytest.raises(ValueError):
        elastic_plan(256, 250, 256, 16)


# ---------------------------------------------------------------------- #
# the launch: gloo at world 4, an injected link fault, a schedule cache
# ---------------------------------------------------------------------- #

def _launch(*extra):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--data-parallel", "4", "--collectives",
         "pipeline", "--steps", "3", "--global-batch", "4", "--seq", "32",
         *extra], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC))


def _losses(stdout):
    return [float(m.group(1)) for m in
            re.finditer(r"^step \d+: loss (\S+)", stdout, re.M)]


def test_launch_survives_a_link_fault_and_reuses_its_cache(tmp_path):
    cache = str(tmp_path / "sc")
    faulted = _launch("--inject-fault", "1:0-1", "--schedule-cache", cache,
                      "--ckpt-dir", str(tmp_path / "ck1"))
    assert faulted.returncode == 0, faulted.stderr[-3000:]
    out = faulted.stdout
    assert "[ft] link fault at step 1" in out
    assert "[repair] axis data" in out
    assert re.fullmatch(r"done at step 3; stragglers: \d+; link faults "
                        r"repaired: True", out.splitlines()[-1])
    # the ranks share the cold cache: whichever compiles first stores
    assert "ScheduleCache[" in out
    assert list((tmp_path / "sc").glob("allreduce-*.json"))
    # the second launch on the same cache compiles nothing
    clean = _launch("--schedule-cache", cache,
                    "--ckpt-dir", str(tmp_path / "ck2"))
    assert clean.returncode == 0, clean.stderr[-3000:]
    assert "hits=2 misses=0" in clean.stdout
    assert re.fullmatch(r"done at step 3; stragglers: \d+; link faults "
                        r"repaired: False", clean.stdout.splitlines()[-1])
    # the repaired ring sums in another order: equal within rounding
    got, ref = _losses(out), _losses(clean.stdout)
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    for r in range(4):
        assert checkpoint.latest_step(str(tmp_path / "ck1" / f"rank{r}")) \
            == 3


def test_launch_without_a_context_retries_the_step(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    records = launch_train.run(launch_train.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "3", "--global-batch",
         "2", "--seq", "16", "--inject-fault", "1:0-1", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "2"]))
    out = capsys.readouterr().out
    assert "no collective context attached" in out
    assert [r["step"] for r in records] == [0, 1, 2]
    assert checkpoint.all_steps(str(tmp_path)) == [2, 3]
