"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, traffic mixes, drivers and metric readers by name."""
import json
import re

import pytest

from bench import harness

from . import tiny

MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench"]
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contracts_keys_and_names(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert _line(e[text]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds_and_the_setup_metric():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


def test_cells_configs_and_traffic_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(MANIFEST["workloads"])
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for c in configs.values():
        assert c["file"].startswith("bench/configs/")
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["name"] == c["name"]
        assert len(c["reduced"]) <= 16


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for w in MANIFEST["workloads"]:
        cell = harness.find_cell(MANIFEST, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names and m["moves"] in e2e


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers == {"train step", "device"}
    layers = {m["layer"] for m in tiny.manifest()["per_layer"]}
    assert layers == {"comms", "kernels", "train step", "device"}


def test_left_out_cells_are_not_in_the_benchmark():
    left = {w["name"] for w in tiny.manifest()["workloads"]} - \
        {w["name"] for w in MANIFEST["workloads"]}
    assert left == {"grad_sync.mamba2-780m.dgx8"}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= \
            {w["name"] for w in MANIFEST["workloads"]}, m


def test_discovery_by_name():
    manifest = tiny.manifest()
    cell = harness.find_cell(manifest, "grad_sync.mamba2-780m.dgx8")
    assert cell.config["name"] == "mamba2-780m"
    assert cell.traffic["driver"] == "grad_sync"
    assert harness.load_driver(cell.traffic["driver"]).run
    assert harness.load_reference(cell.config["reference"]).layout
    assert {m["name"] for m in cell.end_to_end} == {"grad_sync_GBps",
                                                    "setup_s"}
    train = harness.find_cell(MANIFEST, "train_step.mamba2-780m")
    assert [m["name"] for m in train.end_to_end] == ["train_tokens_per_s",
                                                     "setup_s"]
    for m in manifest["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    with pytest.raises(KeyError):
        harness.find_cell(MANIFEST, "no-such-cell")
    with pytest.raises(ValueError):
        harness.load_traffic("../BENCHMARK")
    with pytest.raises(ValueError):
        harness.load_driver("grad_sync.x")


def test_a_metric_without_workloads_follows_what_it_moves():
    manifest = tiny.manifest()
    manifest["per_layer"].append({"name": "x", "unit": "%", "better": "lower",
                                  "source": "device_trace", "layer": "device",
                                  "moves": "train_tokens_per_s"})
    train = harness.find_cell(manifest, "train_step.mamba2-780m")
    sync = harness.find_cell(manifest, "grad_sync.mamba2-780m.dgx8")
    assert "x" in {m["name"] for m in train.per_layer}
    assert "x" not in {m["name"] for m in sync.per_layer}
