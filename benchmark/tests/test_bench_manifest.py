"""The manifest against the contract's shape, and every file it names found
by name."""

import json
import os
import re

import pytest

from benchmark.harness import core, readers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

MAN = core.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert os.path.getsize(core.MANIFEST) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    n = 24
    total = (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert 1 <= MAN["run_seconds"] <= 51 and total <= 43200


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith(
        "benchmark/configs/")
    cfg = core.load_json(os.path.join(core.ROOT, entry["file"]))
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    files = core.cell_files(MAN, cell["name"])
    assert files["traffic"]["driver"] in ("train", "search")
    assert core.generator(files) is not None
    e2e = [m["name"] for m in core.metrics_for(MAN, cell["name"],
                                               "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = core.metrics_for(MAN, cell["name"], "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


def test_metrics():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E
        assert hasattr(readers.load(m["name"]), "read")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_layers_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all("\n" not in x and 1 <= len(x) <= 200 for x in layers)


def test_limits_files_hold_numbers():
    for w in MAN["workloads"]:
        lim = core.load_json(core.named_file("limits", w["name"]))
        assert lim and all(isinstance(v, float) and v > 0
                           for v in lim.values())


def test_json_round_trip():
    with open(core.MANIFEST) as f:
        assert json.load(f) == MAN
