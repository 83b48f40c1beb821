"""BENCHMARK.json against the manifest's rules: names, units, keys,
files, and what each cell reports."""

import json
import os
import re

import pytest

from portbench import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and M["paths"] == ["portbench"]
    assert all(LINE.match(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    n = 24
    assert (2 + 14 * n) * (M["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        extra = set(e) - KEYS[section] - {"workloads"}
        assert not extra and KEYS[section] <= set(e), (e["name"], extra)
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_metrics_have_readers_and_sources():
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    e2e = {e["name"] for e in M["end_to_end"]}
    assert "setup_s" in e2e
    by_name = {e["name"]: e for e in M["end_to_end"]}
    for e in M["per_layer"]:
        assert e["moves"] in e2e
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in e.get("workloads", []):      # each reports what it moves
            assert harness.applies(by_name[e["moves"]], cell, M), e["name"]
    for e in M["end_to_end"] + M["per_layer"]:
        assert os.path.exists(harness.reader_path(e["name"])), e["name"]


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in M["configs"]}
    used = set()
    for cell in M["workloads"]:
        assert cell["chips"] in (1, 4) and cell["config"] in configs
        used.add(cell["config"])
        _, entry, config, traffic = harness.cell_spec(M, cell["name"])
        assert os.path.exists(os.path.join(
            harness.HERE, "drivers", traffic["driver"] + ".py"))
        assert harness.read_json(f"portbench/limits/{cell['name']}.json")
        e2e = [m for m in M["end_to_end"]
               if harness.applies(m, cell["name"], M)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(harness.applies(m, cell["name"], M)
                   for m in M["per_layer"])
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("portbench/configs/")
        assert len(c["reduced"]) <= 16
    pairs = [(c["config"], c["traffic"]) for c in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)


def test_kernel_families_named():
    for family in ("k1", "k3"):
        assert harness.kernel_names(family)
