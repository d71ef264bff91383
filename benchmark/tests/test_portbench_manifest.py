"""BENCHMARK.json against the rules its readers hold it to: names, units,
keys and lengths, and every name found as a file under benchmark/."""
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["command"]) <= 32
    assert all(line(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for w in man["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in man["paths"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51


def test_names_and_units(man):
    groups = [man["configs"], man["workloads"], man["end_to_end"],
              man["per_layer"]]
    for g in groups:
        names = [x["name"] for x in g]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_configs(man):
    assert 1 <= len(man["configs"]) <= 24
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_workloads(man):
    assert 1 <= len(man["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in man["configs"]}
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for sub in (("traffic", w["traffic"] + ".json"),
                    ("cells", w["name"] + ".json")):
            assert os.path.exists(os.path.join(BENCH, *sub)), sub


def test_metrics(man):
    e2e = man["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(man["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        keys = {"name", "unit", "better", "bound", "source"}
        assert set(m) - {"workloads"} == keys
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    names = {m["name"] for m in e2e}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in names
        assert line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        mine = [m for m in e2e if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in man["per_layer"])
    assert any("mfu" in m["name"] for m in man["per_layer"])


def test_files_named_from_names():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if "__pycache__" in root:
                continue
            rel = os.path.relpath(os.path.join(root, f), REPO)
            assert PATH.match(rel), rel
