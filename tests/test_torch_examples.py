"""The port's examples on the CPU (`--device cpu`, their smallest flags),
each in its own process: every one exits 0; quickstart_torch's and
schedule_explorer_torch's schedule-level lines are the reference
example's, line for line, before the lines of their run on stacked
ranks; serve_lm_torch serves every request, train_lm_torch reaches its
last step.  Without --device they ask for the card and, with none here,
exit with an error instead of falling back to the CPU."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def run(script, *argv):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *argv],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu"))
    return out


@pytest.mark.parametrize("script,argv", [
    ("quickstart", []),
    ("schedule_explorer", ["--topo", "hypercube3", "--chunks", "8"]),
    ("schedule_explorer", ["--topo", "circulant16", "--kind", "alltoall"]),
])
def test_schedule_lines_equal_the_reference_example(script, argv):
    ref = run(f"{script}.py", *argv)
    assert ref.returncode == 0, ref.stderr[-2000:]
    got = run(f"{script}_torch.py", *argv, "--device", "cpu")
    assert got.returncode == 0, got.stderr[-2000:]
    want = ref.stdout.splitlines()
    lines = got.stdout.splitlines()
    assert lines[:len(want)] == want
    assert re.search(r"executed .*on \d+ stacked ranks \(cpu\)",
                     "\n".join(lines[len(want):]))
    if script == "quickstart":
        # the CPU takes chunk_accum's plain version: no launch
        assert lines[-1] == "chunk_accum launches: 0"


def test_serve_lm_torch_serves_every_request():
    out = run("serve_lm_torch.py", "--device", "cpu", "--requests", "2",
              "--new-tokens", "3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(re.findall(r"^req \d+: prompt \d+ tokens -> generated 3:",
                          out.stdout, re.M)) == 2, out.stdout


def test_train_lm_torch_reaches_its_last_step(tmp_path):
    out = run("train_lm_torch.py", "--device", "cpu", "--steps", "3",
              "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "finished at step 3;" in out.stdout, out.stdout
    loss = float(re.search(r"step 0: loss=(\S+)", out.stdout).group(1))
    assert 0 < loss < 10


@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "schedule_explorer_torch.py",
                                    "serve_lm_torch.py",
                                    "train_lm_torch.py"])
def test_examples_default_to_the_card(script, tmp_path):
    """The default device is cuda: with no card the example raises (it
    never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    out = run(script, *(["--ckpt-dir", str(tmp_path)]
                        if script == "train_lm_torch.py" else []))
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
