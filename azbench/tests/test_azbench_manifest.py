"""BENCHMARK.json against the benchmark's contract, and the files it names."""
import json
import math
import re

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    path = harness.ROOT / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    return json.loads(path.read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and key != "model"
            assert key in data
        changed = {k.split(".")[0] for k in data["changed"]}
        assert changed == set(c["reduced"])
        assert "model" not in changed


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        cell = harness.cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert (harness.HERE / "kinds"
                / f"{cell['traffic_data']['kind']}.py").exists()
        assert all(math.isfinite(v) and v >= 0
                   for v in cell["limits"].values())


def _metric(m, per_layer):
    base = {"name", "unit", "better", "source"}
    base |= {"layer", "moves"} if per_layer else {"bound"}
    assert set(m) - {"workloads"} == base
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    for m in bench["end_to_end"]:
        _metric(m, False)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(bench["per_layer"]) <= 128
    names = set(e2e)
    layers = set()
    for m in bench["per_layer"]:
        _metric(m, True)
        assert m["name"] not in names
        names.add(m["name"])
        assert _line(m["layer"])
        layers.add(m["layer"])
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for cell in cells:
        reports = [m for m in bench["end_to_end"]
                   if cell in m.get("workloads", cells)]
        assert len(reports) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    perf = (harness.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf
