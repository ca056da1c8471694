"""Host spans and the reduction of a device trace to what the per-layer
metrics read.

`Spans` records the benchmark's own spans around its calls into each layer
of the program (host clock, `perf_counter_ns`).  `DeviceTrace` profiles the
card's activity (`torch.profiler`, CUDA activity only, so no host op is
recorded) over a window that the driver opens and closes with
`torch.cuda.synchronize()`; the first and last synchronize calls in the
trace mark the window on the profiler's clock and align the spans with it.
`DeviceTrace.summary` reduces the trace without building the profiler's
event tree:

* busy seconds: the union of the device intervals of every kernel, copy
  and set inside the window (streams that overlap, as NCCL's do, count
  once);
* launches: the device operations inside the window;
* device seconds by operation name;
* idle seconds by host span: each gap in the union, split over the spans
  that cover it (`untraced` for what no span covers).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

Interval = Tuple[int, int]


class Spans:
    """(name, start ns, end ns) of the benchmark's host spans."""

    def __init__(self) -> None:
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter_ns()))


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    op_seconds: Dict[str, float]
    idle_by_span: Dict[str, float]

    def seconds_of(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds `fragment`."""
        return sum(s for n, s in self.op_seconds.items() if fragment in n)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.op_seconds.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.idle_by_span.items(),
                                          key=lambda kv: -kv[1])[:n]]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi) that the disjoint sorted `busy` leaves free."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(free: List[Interval],
                 spans: List[Tuple[str, int, int]]) -> Dict[str, float]:
    """Seconds of each free interval under each span (spans sorted by start
    and not nested), the rest under `untraced`."""
    out: Dict[str, float] = {}
    spans = sorted(spans, key=lambda s: s[1])
    j = 0
    for a, b in free:
        covered = 0
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < b:
            name, s0, s1 = spans[k]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part / 1e9
                covered += part
            k += 1
        if b - a > covered:
            out["untraced"] = out.get("untraced", 0.0) + (b - a - covered) / 1e9
    return out


class DeviceTrace:
    """Profiles the card's activity while open; the driver's window inside
    it starts and ends with `torch.cuda.synchronize()`."""

    def __init__(self, spans: Spans) -> None:
        self.spans = spans
        self.prof = None

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.prof.__exit__(*exc)

    def summary(self, window_s: float, host_t0_ns: int) -> TraceSummary:
        """`window_s` and `host_t0_ns`: the driver's window on the host
        clock, which starts when its first synchronize returns."""
        from torch.autograd import DeviceType
        ops: List[Tuple[str, int, int]] = []
        syncs: List[Interval] = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ops.append((e.name(), e.start_ns(), e.end_ns()))
            elif e.name() == "cudaDeviceSynchronize":
                syncs.append((e.start_ns(), e.end_ns()))
        if not ops:
            raise RuntimeError("the profiler recorded no device operation")
        if len(syncs) >= 2:
            lo, hi = min(syncs)[1], max(syncs)[1]
        else:       # no runtime events: the operations bound the window
            lo, hi = min(o[1] for o in ops), max(o[2] for o in ops)
        inside = [o for o in ops if o[2] > lo and o[1] < hi]
        busy = union([(max(a, lo), min(b, hi)) for _, a, b in inside])
        op_seconds: Dict[str, float] = {}
        for name, a, b in inside:
            op_seconds[name] = op_seconds.get(name, 0.0) + (b - a) / 1e9
        shift = lo - host_t0_ns
        spans = [(n, a + shift, b + shift) for n, a, b in self.spans.items]
        return TraceSummary(
            window_s=window_s,
            busy_s=sum(b - a for a, b in busy) / 1e9,
            launches=len(inside), op_seconds=op_seconds,
            idle_by_span=idle_by_span(gaps(busy, lo, hi), spans))


def mean_summary(parts: List[TraceSummary]) -> TraceSummary:
    """Several devices' summaries as one: seconds and launches averaged
    over the devices, the window the longest."""
    n = len(parts)

    def avg(dicts: List[Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for d in dicts:
            for k, v in d.items():
                out[k] = out.get(k, 0.0) + v / n
        return out
    return TraceSummary(
        window_s=max(p.window_s for p in parts),
        busy_s=sum(p.busy_s for p in parts) / n,
        launches=round(sum(p.launches for p in parts) / n),
        op_seconds=avg([p.op_seconds for p in parts]),
        idle_by_span=avg([p.idle_by_span for p in parts]))
