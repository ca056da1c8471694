"""On the card, at each cell's own size: the control fails the cell's
limits on three seeds, and a short run of the cell comes out correct.
Skipped without a CUDA card (or without the cards a cell asks for); on
the card's machine: `PYTHONPATH=src python -m pytest -m card bench/tests`."""
import json
import subprocess
import sys

import pytest

from bench import control, harness

from . import tiny

CONTROLS = [("grad_sync.mamba2-780m.dgx8", "control"),
            ("train_step.mamba2-780m", "control"),
            ("train_step.mamba2-780m", "half_batch")]


def _cell_on_the_card(name):
    import torch
    cell = harness.find_cell(tiny.manifest(), name)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} CUDA card(s)")
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name,what", CONTROLS)
def test_the_control_and_faults_fail_at_the_cells_size(name, what):
    cell = _cell_on_the_card(name)
    reading = control.READINGS[(cell.traffic["driver"], what)]
    for seed in (101, 102, 103):
        got = reading(cell, seed, 3.0, "cuda")
        assert any(v > cell.traffic["limits"][k] for k, v in got.items()), \
            (seed, got)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_manifest()["workloads"]])
def test_a_short_run_is_correct(name):
    _cell_on_the_card(name)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                          "--seed", "104", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
