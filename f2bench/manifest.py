"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix:

  configuration  the `file` of its `configs` entry (under this folder's
                 `configs/`): n_keys, load_batch, the explicit `F2Config`
                 fields (`f2`), the facade and its arguments;
  facade         `facades/<facade>.py`: `build(...)` and `counters(...)`;
  traffic        `traffic/<traffic>.json`: the op mix, the key
                 distribution and the batch (read by `gen.Traffic`);
  metric         `metrics/<name>.py`: `read(record)` returns the value or
                 None where the run holds nothing to read.

A later change adds a cell, a configuration, a mix, a facade or a metric by
adding files and entries; no file here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        f"f2bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, root, data: dict):
        self.root = Path(root)
        self.data = data
        # the benchmark's folder as BENCHMARK.json names it
        self.here = self.root / data["paths"][0]
        self._readers = {}

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def facade(self, name: str):
        return _module(self.here / "facades" / f"{name}.py")

    def reader(self, name: str):
        if name not in self._readers:
            self._readers[name] = _module(self.here / "metrics" / f"{name}.py")
        return self._readers[name]

    def metrics_of(self, cell: str, per_layer: bool) -> list:
        """The cell's end-to-end metrics, or its per-layer ones: those
        without a `workloads` key, and those that list the cell."""
        group = self.data["per_layer" if per_layer else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def load(root) -> Bench:
    root = Path(root)
    return Bench(root, json.loads((root / "BENCHMARK.json").read_text()))


def problems(data: dict) -> list:
    """Names, units, sources and references that break the manifest's
    rules (an empty list: none)."""
    out = []

    def name(x, what):
        if not isinstance(x, str) or not NAME.match(x):
            out.append(f"{what}: bad name {x!r}")

    configs = {c["name"] for c in data["configs"]}
    cells = {w["name"] for w in data["workloads"]}
    for c in data["configs"]:
        name(c["name"], "config")
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
    for w in data["workloads"]:
        name(w["name"], "workload")
        name(w["traffic"], f"workload {w['name']} traffic")
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"]:
            out.append(f"workload {w['name']}: why")
    for group in ("end_to_end", "per_layer"):
        for m in data[group]:
            name(m["name"], group)
            if not UNIT.match(m["unit"]):
                out.append(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"{m['name']}: better")
            if m["source"] not in SOURCES:
                out.append(f"{m['name']}: source")
            for c in m.get("workloads", []):
                if c not in cells:
                    out.append(f"{m['name']}: unknown workload {c}")
    all_names = [m["name"] for g in ("end_to_end", "per_layer")
                 for m in data[g]]
    for what, names in (("metric", all_names),
                        ("workload", [w["name"] for w in data["workloads"]]),
                        ("config", [c["name"] for c in data["configs"]])):
        if len(names) != len(set(names)):
            out.append(f"duplicate {what} name")
    return out
