"""The port's topology-zoo sweep (repro_torch.cache.sweep) and its
compile-time gate (tools/perf_smoke_torch.py) on the CPU.

Every row's non-timing fields equal the committed `BENCH_schedules.json`
row of the same (name, kind) and the reference's `repro.cache.sweep`
row on the same names: the smoke zoo, a --topology spec with a transform
under --repair (its repair rows too), and --fixed-k 2 on fig1a.  The
timing fields (`compile_time_s`, the `seconds` of `compile_stats`,
`repair_time_s`, `cold_compile_time_s` and the `speedup` made of the last
two) and the document's `compiler` (each package's own fingerprint) are
left out.  A second sweep over the same cache dir stores nothing (pure
hits) and gives the same rows; the CLI exits 1 on a document whose
achieved runtime differs from its claim, and never writes
BENCH_schedules.json."""
import copy
import json
import os
import subprocess
import sys

import pytest

from repro.cache import sweep as ref_sweep
from repro_torch.cache import fingerprint as tfp
from repro_torch.cache import store as tstore
from repro_torch.cache import sweep as tsweep

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMING = ("compile_time_s", "repair_time_s", "cold_compile_time_s",
          "speedup")


def untimed(row):
    out = {k: v for k, v in row.items() if k not in TIMING}
    if out.get("compile_stats"):
        out["compile_stats"] = [{k: v for k, v in r.items()
                                 if k != "seconds"}
                                for r in out["compile_stats"]]
    return out


def same_document(port, ref):
    """Every field but `compiler`, the rows untimed."""
    assert port["compiler"] == tfp.compiler_fingerprint()
    for key in set(port) | set(ref):
        if key in ("compiler", "entries", "skipped", "repair"):
            continue
        assert port[key] == ref[key], key
    for part in ("entries", "skipped", "repair"):
        assert [untimed(e) for e in port.get(part, ())] == \
            [untimed(e) for e in ref.get(part, ())], part


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCH_schedules.json")) as f:
        doc = json.load(f)
    return {(e["name"], e["kind"]): untimed(e) for e in doc["entries"]}


def test_smoke_rows_equal_the_committed_ones_and_the_reference(bench):
    port = tsweep.run_sweep(names=tsweep.SMOKE_NAMES, jobs=1)
    same_document(port, ref_sweep.run_sweep(names=ref_sweep.SMOKE_NAMES,
                                            jobs=1))
    assert len(port["entries"]) == len(tsweep.SMOKE_NAMES) * \
        len(tsweep.COLLECTIVES)
    for e in port["entries"]:
        assert untimed(e) == bench[(e["name"], e["kind"])], e["name"]
    assert tsweep.claim_mismatches(port) == []


def test_topology_spec_under_repair_equals_the_reference():
    spec = ["multipod:2x4@degrade(0-9,cap=9)"]
    port = tsweep.run_sweep(topologies=spec, repair=True, jobs=1)
    same_document(port, ref_sweep.run_sweep(topologies=spec, repair=True,
                                            jobs=1))
    rows = [e for e in port["repair"] if "skipped" not in e]
    assert rows and all(e["bytes_equal"] for e in rows)
    assert tsweep.repair_mismatches(port) == []


def test_fixed_k_equals_the_reference():
    port = tsweep.run_sweep(names=["fig1a"], fixed_k=2, jobs=1)
    same_document(port, ref_sweep.run_sweep(names=["fig1a"], fixed_k=2,
                                            jobs=1))
    assert port["fixed_k"] == 2 and port["entries"]
    assert {e["kind"] for e in port["entries"]} | {
        e["kind"] for e in port["skipped"]} == set(
            tsweep.FIXED_K_COLLECTIVES)


def test_second_sweep_over_the_cache_is_pure_hits(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    first = tsweep.run_sweep(names=tsweep.SMOKE_NAMES, jobs=1,
                             cache_dir=cache)
    stored = sorted(os.listdir(cache))

    def no_store(self, key, art):
        raise AssertionError(f"the second sweep compiled and stored {key}")
    monkeypatch.setattr(tstore.ScheduleCache, "_store", no_store)
    second = tsweep.run_sweep(names=tsweep.SMOKE_NAMES, jobs=1,
                              cache_dir=cache)
    assert sorted(os.listdir(cache)) == stored
    assert [untimed(e) for e in second["entries"]] == \
        [untimed(e) for e in first["entries"]]


def test_cli_exits_1_on_a_claim_mismatch_and_keeps_the_scoreboard(
        tmp_path, monkeypatch, capsys):
    assert "BENCH_schedules.json" not in (tsweep.default_out_path(True),
                                          tsweep.default_out_path(False))
    monkeypatch.chdir(tmp_path)
    assert tsweep.main(["--smoke", "--collectives", "allgather"]) == 0
    assert os.listdir(tmp_path) == ["BENCH_schedules.torch.smoke.json"]
    real = tsweep.run_sweep

    def doctored(**kwargs):
        doc = copy.deepcopy(real(**kwargs))
        doc["entries"][0]["achieved_over_claimed"] = "2"
        return doc
    monkeypatch.setattr(tsweep, "run_sweep", doctored)
    assert tsweep.main(["--smoke", "--collectives", "allgather", "--out",
                        str(tmp_path / "doctored.json")]) == 1
    assert "achieved != claimed" in capsys.readouterr().err


# ---------------------------------------------------------------------- #
# tools/perf_smoke_torch.py --measured
# ---------------------------------------------------------------------- #

def _gate(*argv):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "perf_smoke_torch.py"),
         *argv], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def _with_pack_seconds(doc, extra):
    """doc with `extra` seconds added to each row's pack stage (which the
    gate then checks on its own, the total above ABS_FLOOR)."""
    doc = copy.deepcopy(doc)
    for e in doc["entries"]:
        for row in e["compile_stats"] or ():
            if row["stage"] == "pack":
                row["seconds"] += extra
    return doc


def test_perf_gate_passes_a_document_against_itself_and_fails_a_slower(
        tmp_path):
    doc = _with_pack_seconds(tsweep.run_sweep(names=tsweep.SMOKE_NAMES,
                                              jobs=1), 0.01)
    base, slow = tmp_path / "base.json", tmp_path / "slow.json"
    base.write_text(json.dumps(doc))
    slow.write_text(json.dumps(_with_pack_seconds(doc, 0.01)))
    # the repair gate times wall clock (best of N); it is left out here,
    # where other tests share the CPU
    ok = _gate("--baseline", str(base), "--measured", str(base),
               "--repair-repeats", "0")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "perf-smoke[stage:pack][OK]" in ok.stdout
    assert "[repair:" not in ok.stdout
    bad = _gate("--baseline", str(base), "--measured", str(slow),
                "--repair-repeats", "0")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "perf-smoke[stage:pack][FAIL]" in bad.stdout
    assert "perf-smoke[total][OK]" in bad.stdout
    # --factor moves the budget: a 3x allowance passes the doubled stage
    assert _gate("--baseline", str(base), "--measured", str(slow),
                 "--factor", "3", "--repair-repeats", "0").returncode == 0
