"""Every name in BENCHMARK.json has its file under sniffbench/ and loads,
and the file keeps to the benchmark contract's shape."""
import importlib
import json
import os
import re

import pytest

from sniffbench.harness import drive

ROOT = drive.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "sniffbench/run.py"]
    assert BENCH["paths"] == ["sniffbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) <= {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and len(cfg["source"]) <= 200
    body = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    for k in ("n_prb", "nof_ports", "nof_rx_ant", "n_id_cell", "cfi",
              "guarantees"):
        assert k in body
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(wl):
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and wl["chips"] in (1, 4)
    assert 1 <= len(wl["why"]) <= 200
    cell = drive.load_cell(wl["name"])
    assert cell["workload"]["config"] == wl["config"]
    assert cell["workload"]["traffic"] == wl["traffic"]
    assert cell["config"]["name"] == wl["config"]
    assert 10240 % cell["mix"]["block_sf"] == 0
    assert cell["mix"]["block_sf"] % 160 == 0
    assert set(cell["workload"]["limits"]) == {"wrong_pct", "bad_payloads"}
    assert drive.mode_of(cell["config"]).__name__.endswith(".dl")
    control = importlib.import_module(
        f"sniffbench.controls.{cell['workload']['control']}")
    assert callable(control.plant)
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    read = drive.reader(m["name"])
    assert callable(read)
    if m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    else:
        assert m["moves"] == "sf_per_s" and m["layer"]
        # nothing to read: no number, never a 0
        assert read({"config": {}, "n_iter": 2}) is None
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def test_configs_used_and_pairs_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_a_mode_without_an_entry_is_refused():
    with pytest.raises(ValueError, match="no entry for mode 'ul'"):
        drive.mode_of({"name": "ul20_dual", "mode": "ul"})
    with pytest.raises(ValueError, match="no entry for mode None"):
        drive.mode_of({"name": "no_mode"})


def test_every_metric_module_imports():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        importlib.import_module(f"sniffbench.metrics.{m['name']}")
