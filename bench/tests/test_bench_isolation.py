"""What the benchmark may not do: import JAX or the JAX package (whole
top-level names; `repro_torch` is the port), read the JAX package's
`benchmarks/`, print a result without a card, or run without the
program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from bench import harness

from . import tiny

BENCH = harness.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        names = set(_imported(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)


def test_nothing_under_bench_reads_benchmarks():
    for path in BENCH.rglob("*"):
        if path.suffix in (".py", ".json") and "tests" not in path.parts:
            assert "benchmarks/" not in path.read_text(), path


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench import harness\n"
            "from bench.tests import tiny\n"
            "res = tiny.run(tiny.cell('grad_sync.mamba2-780m.dgx8'))\n"
            "res2 = tiny.run(tiny.cell('train_step.mamba2-780m'))\n"
            "assert res.correct and res2.correct\n"
            "print(harness.forbidden_modules())\n"
            % (str(harness.ROOT), str(harness.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run_cli(root: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "train_step.mamba2-780m", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root, env=env)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    out = _run_cli(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_it_exits_non_zero(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = _run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_the_result_line_has_the_contracts_keys():
    cell = harness.find_cell(tiny.manifest(), "grad_sync.mamba2-780m.dgx8")
    res = harness.RunResult(attempted=3, failed=0,
                            end_to_end={"grad_sync_GBps": 0.1,
                                        "setup_s": 9.0},
                            counters={}, checks={"sum_rel_err": (1e-7, 1e-5)},
                            memory_peak_bytes=5, window_s=10.0)
    line = harness.result_line(cell, res, False, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["metrics"] == {"grad_sync_GBps": {"value": 0.1,
                                                  "unit": "GB/s"},
                               "setup_s": {"value": 9.0, "unit": "s"}}
    assert line["device"]["platform"] == "gpu" and line["correct"]
    json.dumps(line)
