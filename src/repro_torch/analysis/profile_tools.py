"""Per-op cost attribution for the perf loop: where do the bytes and
collective bytes of a counted step go?  Counterpart of
src/repro/analysis/profile_tools.py.

`top_contributors` ranks the records of `hlo_count.Counter` (every distinct
op with its count of calls) as the reference ranks the ops of an HLO
module with their trip counts.  `top_device_kernels` gives the card's own
view: the device kernels of one `torch.profiler` step by time.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def top_contributors(records, n: int = 12, kind_filter=None
                     ) -> List[Tuple[float, float, str, str]]:
    """[(bytes, mult, kind, line)] sorted desc: `mult` is the op's count of
    calls and `bytes` its bytes over all of them (a collective's, its wire
    bytes, with kind "COLL:<kind>")."""
    out = list(records)
    if kind_filter:
        out = [o for o in out if kind_filter in o[2]]
    out.sort(reverse=True)
    return out[:n]


def device_profile(fn, n: int = 8) -> Dict[str, object]:
    """One call of `fn` on the card under torch.profiler: its wall seconds
    (between synchronizes), device busy seconds (the sum of kernel times),
    the kernel launches, and the top `n` kernels as [name, ms, calls]."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.self_device_time_total, reverse=True)
    host = {e.key: e.count for e in events}
    return {"wall_s": wall,
            "busy_s": sum(e.self_device_time_total for e in on_device) / 1e6,
            "launches": host.get("cudaLaunchKernel", 0),
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3,
                             e.count] for e in on_device[:n]]}
