"""BENCHMARK.json keeps to its rules: names, units, sources, the cells'
references, and the files each name leads to."""
import copy
import json

import pytest

from conftest import ROOT
from f2bench import manifest

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_is_clean():
    assert manifest.problems(DATA) == []


def test_keys_are_exactly_the_contracts():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_name_leads_to_its_file():
    bench = manifest.load(ROOT)
    for w in DATA["workloads"]:
        conf = bench.config(w["config"])
        assert bench.traffic(w["traffic"])["batch"] > 0
        assert hasattr(bench.facade(conf["facade"]), "build")
        assert w["chips"] == 1
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert hasattr(bench.reader(m["name"]), "read")
    ends = {m["name"] for m in DATA["end_to_end"]}
    assert "setup_s" in ends
    for m in DATA["per_layer"]:
        assert m["moves"] in ends
    for w in DATA["workloads"]:
        assert bench.metrics_of(w["name"], per_layer=True)


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "-lead", "x" * 65,
                                 "µs"])
def test_bad_names_are_refused(bad):
    data = copy.deepcopy(DATA)
    data["workloads"][0]["name"] = bad
    assert manifest.problems(data)


@pytest.mark.parametrize("unit,ok", [("ops/s", True), ("%", True),
                                     ("B/B", True), ("tokens per s", False),
                                     ("x" * 17, False), ("µs", False)])
def test_units(unit, ok):
    data = copy.deepcopy(DATA)
    data["end_to_end"][0]["unit"] = unit
    assert (manifest.problems(data) == []) == ok


def test_duplicates_and_dangling_references_are_refused():
    data = copy.deepcopy(DATA)
    data["per_layer"].append(copy.deepcopy(data["per_layer"][0]))
    assert manifest.problems(data)
    data = copy.deepcopy(DATA)
    data["per_layer"][0]["workloads"] = ["no_such_cell"]
    assert manifest.problems(data)
