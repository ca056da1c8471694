"""Cells of the benchmark cut to a size the CPU tests can hold: the cell's
own traffic mix and limits, a same-family configuration of tiny widths.

`manifest()` is BENCHMARK.json with the entries of `left_out.json`: cells
proved on the card and left out of the benchmark (PERF.md, Open
questions), their entries as they stood, so that their driver, metric
readers and checks stay tested until a later PR brings them back."""
import copy
import json
from pathlib import Path

from bench import harness

LEFT_OUT = Path(__file__).resolve().parent / "left_out.json"

TINY = {"name": "tiny-ssm", "reference": "mamba2_lm", "family": "ssm",
        "num_layers": 4, "d_model": 64, "num_heads": 0, "num_kv_heads": 0,
        "head_dim": 16, "d_ff": 0, "vocab_size": 256, "ssm_state_dim": 16,
        "ssm_head_dim": 16, "ssm_expand": 2, "ssm_chunk": 16,
        "ssm_conv_width": 4, "tie_embeddings": True, "norm_eps": 1e-6,
        "max_seq_len": 512}


def manifest() -> dict:
    m = harness.load_manifest()
    for section, entries in json.loads(LEFT_OUT.read_text()).items():
        m[section] = m[section] + entries
    return m


def cell(name: str, **traffic) -> harness.Cell:
    """The cell `name` of `manifest()` on TINY, its traffic changed by
    `traffic`; gradient buckets of 16 KiB and sequences of 64."""
    c = copy.deepcopy(harness.find_cell(manifest(), name))
    c.config = dict(TINY)
    if c.traffic["driver"] == "grad_sync":
        c.traffic["bucket_bytes"] = 16384
    else:
        c.traffic["seq_len"] = 64
    c.traffic.update(traffic)
    return c


def run(c: harness.Cell, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
        trace: bool = False) -> harness.RunResult:
    return harness.run_cell(c, seed, seconds, trace, "cpu", 0.0)
