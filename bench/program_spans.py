"""The program's own spans (`repro_torch.obs`) laid over the device trace:
each device operation put down to the innermost program span whose code
launched it, each idle gap to the innermost span that covers it.

`ProgramTrace` is `bench.trace.DeviceTrace` with the program's recorder on
while it is open.  Its summary, a `SpanSummary`, keeps the busy seconds,
launches and operation seconds of `DeviceTrace.summary` as that computes
them, gives `idle_by_span` under the innermost rule (for spans that do not
nest it is `bench.trace.idle_by_span`), and adds:

* `device_by_span`: device seconds by program span name, each span's
  including those of the spans nested in it;
* `launches_by_span`: the device operations by program span name, counted
  likewise.

An operation goes to the innermost program span covering the start of the
CUDA runtime call that launched it (kineto gives both the call's
correlation id), and to every span enclosing that one; `untraced` where no
program span covers the call, `unmatched` where no call has its
correlation id.  A span's device seconds are the union of its operations'
intervals inside the window, so streams that overlap count once.  The
program stamps its spans on the Unix clock, to which kineto converts its
events; the benchmark's own spans (`perf_counter_ns`) are shifted onto it
as `DeviceTrace.summary` shifts them, and for an idle gap the program's
spans nest inside them.  A program without the recorder records no span:
its operations are all `untraced`.

`step_ms` reads the train step's parts in device milliseconds a step.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import heapq
import importlib.util
from typing import Dict, List, Optional, Sequence, Tuple

from bench.trace import DeviceTrace, TraceSummary, gaps, union

UNTRACED, UNMATCHED = "untraced", "unmatched"
# (name, start ns, end ns or None, parent index or None)
ProgramSpan = Tuple[str, int, Optional[int], Optional[int]]


@dataclasses.dataclass
class SpanSummary(TraceSummary):
    device_by_span: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches_by_span: Dict[str, int] = dataclasses.field(default_factory=dict)


def innermost(spans: Sequence[tuple]) -> List[Tuple[int, int, int]]:
    """[(start, end, i)]: sorted, disjoint pieces of the time that spans
    (name, start, end, ...) cover, each with the index of its innermost
    span: of those open there, the one that started last (of two that
    started together, the later in the list).  Spans not ended are left
    out."""
    live = [i for i, s in enumerate(spans)
            if s[2] is not None and s[2] > s[1]]
    bounds = sorted({t for i in live for t in spans[i][1:3]})
    order = sorted(live, key=lambda i: spans[i][1])
    heap: List[Tuple[int, int]] = []
    out: List[Tuple[int, int, int]] = []
    j = 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(order) and spans[order[j]][1] <= a:
            heapq.heappush(heap, (-spans[order[j]][1], -order[j]))
            j += 1
        while heap and spans[-heap[0][1]][2] <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        i = -heap[0][1]
        if out and out[-1][2] == i and out[-1][1] == a:
            out[-1] = (out[-1][0], b, i)
        else:
            out.append((a, b, i))
    return out


def idle_innermost(free: List[Tuple[int, int]],
                   spans: Sequence[tuple]) -> Dict[str, float]:
    """Seconds of each free interval under its innermost span (`innermost`),
    the rest under `untraced`."""
    segs = innermost(spans)
    out: Dict[str, float] = {}
    k = 0
    for a, b in free:
        covered = 0
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        m = k
        while m < len(segs) and segs[m][0] < b:
            s0, s1, i = segs[m]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                out[spans[i][0]] = out.get(spans[i][0], 0.0) + part / 1e9
                covered += part
            m += 1
        if b - a > covered:
            out[UNTRACED] = out.get(UNTRACED, 0.0) + (b - a - covered) / 1e9
    return out


def attribute(ops: List[Tuple[int, int, int]], calls: Dict[int, int],
              spans: Sequence[ProgramSpan], lo: int, hi: int
              ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(device seconds, operations) by program span name of the window's
    operations (start, end, correlation id); `calls`: correlation id -> the
    start of the runtime call with that id."""
    segs = innermost(spans)
    starts = [s[0] for s in segs]
    chains: Dict[int, List[str]] = {}

    def chain(i: int) -> List[str]:
        if i not in chains:
            names, j = [], i
            while j is not None:
                if spans[j][0] not in names:
                    names.append(spans[j][0])
                j = spans[j][3]
            chains[i] = names
        return chains[i]

    pieces: Dict[str, List[Tuple[int, int]]] = {}
    launches: Dict[str, int] = {}
    for a, b, corr in ops:
        t = calls.get(corr)
        if t is None:
            names = [UNMATCHED]
        else:
            k = bisect.bisect_right(starts, t) - 1
            names = chain(segs[k][2]) if k >= 0 and t < segs[k][1] \
                else [UNTRACED]
        for name in names:
            pieces.setdefault(name, []).append((max(a, lo), min(b, hi)))
            launches[name] = launches.get(name, 0) + 1
    device = {n: sum(y - x for x, y in union(p)) / 1e9
              for n, p in pieces.items()}
    return device, launches


def recording():
    """The program's recorder, or an empty list where it has none."""
    if importlib.util.find_spec("repro_torch.obs") is None:
        return contextlib.nullcontext([])
    from repro_torch import obs
    return obs.recording()


class ProgramTrace(DeviceTrace):
    """`DeviceTrace` with the program's recorder on while it is open."""

    def __enter__(self) -> "ProgramTrace":
        super().__enter__()
        self._recording = recording()
        self.program = self._recording.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            self._recording.__exit__(*exc)
        finally:
            super().__exit__(*exc)

    def summary(self, window_s: float, host_t0_ns: int) -> SpanSummary:
        from torch.autograd import DeviceType
        base = super().summary(window_s, host_t0_ns)
        ops: List[Tuple[int, int, int]] = []
        calls: Dict[int, int] = {}
        syncs: List[Tuple[int, int]] = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id()))
            else:
                if e.correlation_id():
                    calls[e.correlation_id()] = e.start_ns()
                if e.name() == "cudaDeviceSynchronize":
                    syncs.append((e.start_ns(), e.end_ns()))
        # the window as DeviceTrace.summary bounds it
        if len(syncs) >= 2:
            lo, hi = min(syncs)[1], max(syncs)[1]
        else:
            lo, hi = min(o[0] for o in ops), max(o[1] for o in ops)
        inside = [o for o in ops if o[1] > lo and o[0] < hi]
        program = [(s.name, s.start_ns, s.end_ns, s.parent)
                   for s in self.program]
        device, launches = attribute(inside, calls, program, lo, hi)
        shift = lo - host_t0_ns
        ours = [(n, a + shift, b + shift) for n, a, b in self.spans.items]
        busy = union([(max(a, lo), min(b, hi)) for a, b, _ in inside])
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(TraceSummary)}
        fields["idle_by_span"] = idle_innermost(gaps(busy, lo, hi),
                                                ours + program)
        return SpanSummary(**fields, device_by_span=device,
                           launches_by_span=launches)


def step_ms(summary: SpanSummary, steps: int) -> Dict[str, float]:
    """The train step's parts, device ms a step: the forward pass, remat's
    recomputation, the backward pass without it, AdamW, and the chunked SSD
    wherever it runs.  Empty without the program's spans."""
    d = summary.device_by_span
    if not steps or "train.forward" not in d:
        return {}
    ms = 1000.0 / steps
    return {"train.forward_ms": d["train.forward"] * ms,
            "train.recompute_ms": d.get("train.recompute", 0.0) * ms,
            "train.backward_ms": (d.get("train.backward", 0.0)
                                  - d.get("train.recompute", 0.0)) * ms,
            "train.adamw_device_ms": d.get("train.adamw", 0.0) * ms,
            "train.ssd_ms": d.get("ssm.ssd", 0.0) * ms}


def report(summary: SpanSummary, steps: int) -> Dict[str, object]:
    """What the spans say of a traced run: the parts a step, the device
    time outside every program span, the parts' and that time's sum over
    the busy time less 1 (0: nothing counted twice or lost), and the share
    of operations matched to a launch."""
    d, n = summary.device_by_span, summary.launches_by_span
    parts = step_ms(summary, steps)
    outside = d.get(UNTRACED, 0.0) + d.get(UNMATCHED, 0.0)
    out: Dict[str, object] = {
        "device_s": d, "launches": n, "steps": steps,
        "launches_total": summary.launches,
        "matched_share": 1.0 - n.get(UNMATCHED, 0) / max(summary.launches, 1),
        "step_ms": parts}
    if parts:
        out["outside_ms"] = outside * 1000.0 / steps
        out["partition_residue"] = (
            (sum(v for k, v in parts.items() if k != "train.ssd_ms")
             * steps / 1000.0 + outside) / summary.busy_s - 1.0)
    return out
