"""The program's spans over the device trace (bench/program_spans.py): the
innermost rule, the attribution of hand-made events (operations matched to
their launch by correlation id, the innermost span, the union within a
span, the partition into spans and the time outside them), the summary
through a hand-made profile, the train step's parts a step; and on the
card, the clock the spans share with the profiler and the share of
operations matched to a launch."""
import json
import statistics
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench import program_spans as ps
from bench.trace import DeviceTrace, Spans, idle_by_span
from repro_torch.obs import Span

# a step on the program's clock: forward 0-100 (its SSD 20-40), backward
# 100-300 (a layer recomputed 120-150 with its SSD 130-140, then the SSD's
# backward 160-180), AdamW 300-400
PROGRAM = [("train.forward", 0, 100, None), ("ssm.ssd", 20, 40, 0),
           ("train.backward", 100, 300, None),
           ("train.recompute", 120, 150, 2), ("ssm.ssd", 130, 140, 3),
           ("ssm.ssd", 160, 180, 2), ("train.adamw", 300, 400, None),
           ("never.closed", 350, None, None)]


def test_innermost_pieces_and_idle_under_nested_spans():
    segs = ps.innermost(PROGRAM)
    assert segs == [(0, 20, 0), (20, 40, 1), (40, 100, 0), (100, 120, 2),
                    (120, 130, 3), (130, 140, 4), (140, 150, 3),
                    (150, 160, 2), (160, 180, 5), (180, 300, 2),
                    (300, 400, 6)]
    # the benchmark's span -5-410 holds them all: a gap 395-415 is AdamW's
    # to 400, the benchmark span's to 410, no span's after
    ours = [("train.loss_and_grad", -5, 410)]
    got = ps.idle_innermost([(10, 25), (135, 165), (395, 415)],
                            ours + PROGRAM)
    assert got == pytest.approx({
        "train.forward": 10e-9, "ssm.ssd": 15e-9, "train.recompute": 10e-9,
        "train.backward": 10e-9, "train.adamw": 5e-9,
        "train.loss_and_grad": 10e-9, "untraced": 5e-9})
    # spans that do not nest: what bench.trace.idle_by_span gives
    free, flat = [(3, 5), (9, 12), (13, 15)], [("a", 2, 4), ("b", 4, 10)]
    assert ps.idle_innermost(free, flat) == \
        pytest.approx(idle_by_span(free, flat))
    # two spans that start together: the later one is the inner
    assert ps.innermost([("p", 0, 10), ("c", 0, 5)]) == [(0, 5, 1),
                                                         (5, 10, 0)]


# (start, end, correlation id) on the device; correlation id -> the start
# of its runtime call on the host
OPS = [(5, 15, 1),          # launched in the forward's SSD
       (12, 18, 2),         # forward, overlapping the op before it
       (125, 135, 3),       # recompute
       (132, 139, 4),       # the recompute's SSD
       (161, 170, 5),       # the backward's SSD
       (190, 230, 6),       # backward
       (310, 330, 7),       # AdamW
       (332, 335, 8),       # launched outside every program span
       (340, 350, 99)]      # no runtime call has its id
CALLS = {1: 25, 2: 50, 3: 121, 4: 131, 5: 165, 6: 185, 7: 305, 8: 500}


def test_operations_go_to_their_launchs_innermost_span_and_its_parents():
    device, launches = ps.attribute(OPS, CALLS, PROGRAM, 0, 1000)
    assert launches == {"ssm.ssd": 3, "train.forward": 2,
                        "train.recompute": 2, "train.backward": 4,
                        "train.adamw": 1, "untraced": 1, "unmatched": 1}
    assert device == pytest.approx({
        "train.forward": 13e-9,         # 5-18, the overlap counted once
        "ssm.ssd": 26e-9,               # 10 + 7 + 9
        "train.recompute": 14e-9,       # 125-139
        "train.backward": 63e-9,        # 14 + 9 + 40
        "train.adamw": 20e-9, "untraced": 3e-9, "unmatched": 10e-9})
    # clipped to the window
    device, _ = ps.attribute(OPS, CALLS, PROGRAM, 8, 320)
    assert device["train.forward"] == pytest.approx(10e-9)
    assert device["train.adamw"] == pytest.approx(10e-9)


class _Event:
    def __init__(self, name, start, end, corr, on_device):
        self._v = (name, start, end, corr, on_device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return DeviceType.CUDA if self._v[4] else DeviceType.CPU


def _profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _traced(cls, program):
    """A trace of OPS and their calls inside a window opened and closed by
    synchronizes (ending at -2 and 1000), the benchmark's span around it
    on a host clock 1000 ns behind."""
    events = [_Event("kernel", a, b, c, True) for a, b, c in OPS]
    events += [_Event("cudaLaunchKernel", t, t + 1, c, False)
               for c, t in CALLS.items()]
    events += [_Event("cudaDeviceSynchronize", -5, -2, 500, False),
               _Event("cudaDeviceSynchronize", 995, 1000, 501, False)]
    spans = Spans()
    spans.items.append(("train.loss_and_grad", -1000, 0))
    tr = cls(spans)
    tr.prof = _profile(events)
    tr.program = program
    return tr.summary(1.002e-6, -1002)


def test_the_summary_keeps_the_device_traces_and_adds_the_spans():
    program = [Span(n, a, b, p, 1) for n, a, b, p in PROGRAM]
    got = _traced(ps.ProgramTrace, program)
    base = _traced(DeviceTrace, program)
    assert isinstance(got, ps.SpanSummary)
    for field in ("window_s", "busy_s", "launches", "op_seconds"):
        assert getattr(got, field) == getattr(base, field)
    assert got.launches_by_span["train.backward"] == 4
    assert got.device_by_span["unmatched"] == pytest.approx(10e-9)
    # the gaps: under the program's spans where they cover them, the
    # benchmark's span (shifted onto 0-1000) elsewhere
    assert got.idle_by_span == pytest.approx({
        "untraced": 2e-9, "train.forward": 67e-9, "ssm.ssd": 32e-9,
        "train.backward": 110e-9, "train.recompute": 15e-9,
        "train.adamw": 67e-9, "train.loss_and_grad": 600e-9})
    assert sum(got.idle_by_span.values()) == pytest.approx(
        sum(base.idle_by_span.values()))


def test_a_program_without_the_recorder_leaves_every_operation_untraced(
        monkeypatch):
    monkeypatch.setattr(ps.importlib.util, "find_spec", lambda name: None)
    with ps.recording() as program:
        assert program == []
    device, launches = ps.attribute(OPS, CALLS, program, 0, 1000)
    assert set(device) == {"untraced", "unmatched"}
    assert launches == {"untraced": 8, "unmatched": 1}


def _summary(device, launches=100):
    return ps.SpanSummary(window_s=2.0, busy_s=sum(device.values()),
                          launches=launches, op_seconds={}, idle_by_span={},
                          device_by_span=device,
                          launches_by_span={"unmatched": 1})


def test_the_step_parts_partition_the_busy_time():
    device = {"train.forward": 0.4, "train.backward": 1.2,
              "train.recompute": 0.3, "train.adamw": 0.2, "ssm.ssd": 0.9,
              "untraced": 0.1, "unmatched": 0.05}
    s = ps.SpanSummary(window_s=2.0, busy_s=1.95, launches=200,
                       op_seconds={}, idle_by_span={},
                       device_by_span=device,
                       launches_by_span={"unmatched": 2})
    parts = ps.step_ms(s, 2)
    assert parts == pytest.approx({
        "train.forward_ms": 200.0, "train.recompute_ms": 150.0,
        "train.backward_ms": 450.0, "train.adamw_device_ms": 100.0,
        "train.ssd_ms": 450.0})
    got = ps.report(s, 2)
    assert got["partition_residue"] == pytest.approx(0.0, abs=1e-12)
    assert got["outside_ms"] == pytest.approx(75.0)
    assert got["matched_share"] == pytest.approx(0.99)
    # nothing to read without the program's spans or without steps
    assert ps.step_ms(_summary({"untraced": 1.0}), 2) == {}
    assert ps.step_ms(s, 0) == {}
    assert "partition_residue" not in ps.report(_summary({"untraced": 1.0}),
                                                2)


WARM = 10


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.card
def test_program_spans_contain_the_profilers_sync_events():
    torch = _card()
    from repro_torch import obs
    torch.cuda.synchronize()
    with ps.ProgramTrace(Spans()) as tr:
        for _ in range(WARM):       # the profiler's first calls are slow
            torch.cuda.synchronize()
        for _ in range(100):
            with obs.span("sync"):
                torch.cuda.synchronize()
    # in order: the warm-up's, the spans', then any of the profiler's own
    syncs = sorted((e.start_ns(), e.end_ns())
                   for e in tr.prof.profiler.kineto_results.events()
                   if e.name() == "cudaDeviceSynchronize")
    assert len(tr.program) == 100 and len(syncs) >= WARM + 100
    lead = [a - s.start_ns for s, (a, _) in zip(tr.program, syncs[WARM:])]
    lag = [s.end_ns - b for s, (_, b) in zip(tr.program, syncs[WARM:])]
    print(json.dumps({"clock_check": {
        "lead_ns": [min(lead), statistics.median(lead), max(lead)],
        "lag_ns": [min(lag), statistics.median(lag), max(lag)]}}))
    assert all(0 <= x <= 50_000 for x in lead + lag), (lead, lag)


@pytest.mark.card
def test_a_train_steps_operations_match_their_launch_and_partition():
    torch = _card()
    import threading
    import time

    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   init_train_state, make_train_step)
    cfg = reduced_config("mamba2-780m", num_layers=4)
    model = build_model(cfg, remat=True)
    params, opt = init_train_state(model, 7, "cuda")
    step = make_train_step(model, TrainConfig(
        optimizer=AdamWConfig(), compute_dtype=torch.bfloat16))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     device="cuda")}
    params, opt, _ = step(params, opt, batch)           # warm-up
    torch.cuda.synchronize()
    with ps.ProgramTrace(Spans()) as tr:
        torch.cuda.synchronize()
        t0, t0_ns = time.perf_counter(), time.perf_counter_ns()
        for _ in range(3):
            params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    s = tr.summary(window, t0_ns)
    got = ps.report(s, 3)
    print(json.dumps({"tiny_step": got}))
    assert got["matched_share"] >= 0.99
    assert abs(got["partition_residue"]) <= 0.01
    # the backward pass's spans come from autograd's own thread and nest
    # by time inside the caller's
    main = threading.get_native_id()
    assert any(p.thread != main for p in tr.program
               if p.name == "ssm.ssd")
    for p in tr.program:
        if p.parent is not None:
            up = tr.program[p.parent]
            assert up.start_ns <= p.start_ns and p.end_ns <= up.end_ns
