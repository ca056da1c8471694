"""`correct` on the CPU at a tiny size, with each cell's own limits: sound
runs come out correct; the control (a lower precision in the program's
place) and each fault the cell can have, planted underneath the timed
path, come out not correct.  The control's readings at the cells' own
sizes are taken on the card (`test_bench_card.py`)."""
import pytest
import torch

from bench import control

from . import tiny

SYNC = ["grad_sync.mamba2-780m.dgx8"]
TRAIN = "train_step.mamba2-780m"


def _limits_failed(cell, readings):
    return [k for k, v in readings.items() if v > cell.traffic["limits"][k]]


@pytest.mark.parametrize("name", SYNC + [TRAIN])
def test_sound_runs_are_correct(name):
    res = tiny.run(tiny.cell(name))
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.failed == 0


def test_the_p2p_cell_is_correct_over_gloo():
    res = tiny.run(tiny.cell(SYNC[0], comm="p2p", ranks=4, topology=None))
    assert res.correct, res.checks
    assert res.counters["devices"] == 4


@pytest.mark.parametrize("name", SYNC)
def test_the_bf16_wire_control_fails(name):
    cell = tiny.cell(name)
    assert _limits_failed(cell, control.grad_sync_control(
        cell, 5, 0.3, "cpu"))


def test_the_fp8_control_fails():
    cell = tiny.cell(TRAIN)
    assert _limits_failed(cell, control.train_control(cell, 5, 0.3, "cpu"))


def test_half_a_batch_fails():
    cell = tiny.cell(TRAIN)
    assert _limits_failed(cell, control.train_half_batch(cell, 5, 0.3,
                                                         "cpu"))


def _unchanged(x, rs, ag, comm, accum_dtype=None):
    return x.clone()


def _half_the_ranks(x, rs, ag, comm, accum_dtype=None):
    half = x[:x.shape[0] // 2].sum(0, keepdim=True) * 2
    return half.expand_as(x).clone()


def _no_exchange(x, rs, ag, comm, accum_dtype=None):
    return x * x.shape[0]


@pytest.mark.parametrize("name", SYNC)
@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange",
                                   "altered"])
def test_sync_faults_are_not_correct(monkeypatch, name, fault):
    from repro_torch.comms import overlap
    real = overlap.tree_all_reduce

    def altered(x, rs, ag, comm, accum_dtype=None):
        out = real(x, rs, ag, comm, accum_dtype=accum_dtype)
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(overlap, "tree_all_reduce", {
        "unchanged": _unchanged, "half": _half_the_ranks,
        "no_exchange": _no_exchange, "altered": altered}[fault])
    assert not tiny.run(tiny.cell(name)).correct


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_faults_are_not_correct(monkeypatch, fault):
    """A step that leaves the state unchanged; one on half of each batch's
    rows; one that moves a parameter twice (an answer altered where it is
    produced)."""
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import AdamWState, global_norm
    whole, update = ts.loss_and_grad, ts.adamw_update

    def unchanged(cfg, grads, state, params):
        return params, AdamWState(state.step + 1, state.mu, state.nu), {
            "grad_norm": global_norm(grads), "lr": 0.0}

    def half(model, params, batch, cfg):
        return whole(model, params, {k: v[:v.shape[0] // 2]
                                     for k, v in batch.items()}, cfg)

    def altered(cfg, grads, state, params):
        before = params.final_norm.detach().clone()
        params, state, metrics = update(cfg, grads, state, params)
        with torch.no_grad():
            params.final_norm.add_(params.final_norm - before)
        return params, state, metrics
    if fault == "half":
        monkeypatch.setattr(ts, "loss_and_grad", half)
    else:
        monkeypatch.setattr(ts, "adamw_update",
                            unchanged if fault == "unchanged" else altered)
    res = tiny.run(tiny.cell(TRAIN))
    assert not res.correct, res.checks


def test_a_check_that_reads_nan_is_not_correct():
    from bench.harness import RunResult
    res = RunResult(1, 0, {}, {}, {"x": (float("nan"), 1.0)}, 0, 1.0)
    assert not res.correct
    assert not RunResult(1, 0, {}, {}, {}, 0, 1.0).correct
