"""Per-op cost attribution for the perf loop: where do the bytes and
collective bytes of a counted step go?  Counterpart of
src/repro/analysis/profile_tools.py.

`top_contributors` ranks the records of `hlo_count.Counter` (every distinct
op with its count of calls) as the reference ranks the ops of an HLO
module with their trip counts.
"""
from __future__ import annotations

from typing import List, Tuple


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
