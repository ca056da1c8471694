"""The frozen FLOP count against a hand count, the per-layer readers'
arithmetic (the bytes rules of the roofline shares among it) on a
hand-made run, and the trace reduction on hand-made intervals."""
import pytest

from bench import flops, harness
from bench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS_BF16
from bench.trace import TraceSummary, gaps, idle_by_span, mean_summary, union

from .tiny import TINY


def test_train_step_flops_of_a_hand_count():
    # d 64, d_inner 128, state 16, heads of 16 (8), chunk 16; 4 layers;
    # vocab 256; batch 2 x 64
    in_out = 2 * 64 * (2 * 128 + 2 * 16 + 8) + 2 * 128 * 64
    ssd = 2 * 8 * 16 + 8 * (2 * 8 * 16 + 2 * 16 * 16 + 2 * 16 * 16)
    head = 2 * 64 * 256
    per_token = 4 * (in_out + ssd) + head
    assert per_token == 291840
    assert flops.train_step_flops(TINY, 2, 64) == 3 * per_token * 2 * 64
    assert flops.train_step_flops(dict(TINY, ssm_chunk=32), 1, 64) == \
        3 * (per_token + 4 * (2 * 8 * 16 + 8 * 2 * 8 * 16)) * 64
    for family in ("dense", "hybrid"):
        with pytest.raises(ValueError):
            flops.train_step_flops(dict(TINY, family=family), 1, 64)


def _run(counters, trace, config=None):
    return harness.RunResult(attempted=1, failed=0, end_to_end={},
                             counters=counters, checks={},
                             memory_peak_bytes=0, window_s=trace.window_s,
                             trace=trace, config=config or {})


TRACE = TraceSummary(window_s=2.0, busy_s=0.5, launches=300,
                     op_seconds={"void chunk_accum_kernel<float>": 0.04,
                                 "Memcpy DtoD": 0.01},
                     idle_by_span={"grad_sync.hook": 1.5})


def _reader(name):
    return harness.load_reader(name)


def test_accumulate_roofline_share_counts_the_least_bytes():
    # 3 buckets of 1e6 elements a rank over 8 ranks, float32 wire, one
    # card: 8 x 3e6 x 4 bytes read, 3e6 x 4 written
    counters = dict(buckets=3, elements=3e6, ranks=8, stacked=True,
                    devices=1, wire_bytes=4)
    least = 8 * 3e6 * 4 + 3e6 * 4
    got = _reader("accumulate.roofline_share")(_run(counters, TRACE))
    assert got == pytest.approx(100 * least / HBM_BYTES_PER_S / 0.04)
    # a bf16 wire halves the reads; four cards share the reduction
    bf16 = dict(counters, wire_bytes=2, devices=4, stacked=False)
    got = _reader("accumulate.roofline_share")(_run(bf16, TRACE))
    assert got == pytest.approx(
        100 * (8 * 3e6 * 2 + 3e6 * 4) / 4 / HBM_BYTES_PER_S / 0.04)
    # nothing to read where the kernel did not run
    none = TraceSummary(2.0, 0.5, 10, {"Memcpy DtoD": 0.01}, {})
    assert _reader("accumulate.roofline_share")(_run(counters, none)) is None


def test_hbm_share_launches_and_idle():
    counters = dict(buckets=3, elements=3e6, ranks=8, stacked=True,
                    devices=1, wire_bytes=4)
    run = _run(counters, TRACE)
    assert _reader("grad_sync.hbm_roofline_share")(run) == pytest.approx(
        100 * 2 * 8 * 3e6 * 4 / HBM_BYTES_PER_S / 2.0)
    assert _reader("grad_sync.hbm_roofline_share")(
        _run(dict(counters, stacked=False), TRACE)) is None
    assert _reader("grad_sync.launches_per_bucket")(run) == 100
    assert _reader("idle_share.grad_sync")(run) == pytest.approx(75.0)
    assert _reader("idle_share.train")(run) == pytest.approx(75.0)
    untraced = harness.RunResult(1, 0, {}, counters, {}, 0, 1.0)
    assert _reader("grad_sync.launches_per_bucket")(untraced) is None


def test_train_readers():
    counters = dict(steps=4, batch=2, seq=64, adamw_s=[0.01, 0.03])
    run = _run(counters, TRACE, TINY)
    assert _reader("train_step_mfu")(run) == pytest.approx(
        100 * 4 * flops.train_step_flops(TINY, 2, 64) / 2.0
        / PEAK_FLOPS_BF16)
    assert _reader("train.adamw_ms")(run) == pytest.approx(20.0)


def test_trace_reduction_of_hand_intervals():
    busy = union([(5, 8), (0, 2), (1, 3), (7, 9), (12, 13)])
    assert busy == [(0, 3), (5, 9), (12, 13)]
    free = gaps(busy, 0, 15)
    assert free == [(3, 5), (9, 12), (13, 15)]
    spans = [("a", 2, 4), ("b", 4, 10)]
    got = idle_by_span(free, spans)
    assert got == pytest.approx({"a": 1e-9, "b": 2e-9,
                                 "untraced": 4e-9})
    two = mean_summary([TRACE, TraceSummary(3.0, 1.5, 100, {"x": 0.2},
                                            {"a": 1.0})])
    assert two.window_s == 3.0 and two.busy_s == 1.0 and two.launches == 200
    assert two.op_seconds["x"] == pytest.approx(0.1)
    assert TRACE.top_ops(1) == [["void chunk_accum_kernel<float>", 0.04]]
