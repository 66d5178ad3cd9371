"""A tiny copy of the benchmark for CPU tests: the real folder's files
copied under a temporary root, with a configuration of 2**14 keys (the
paper's budget split at that size, the plain `fused_ref` engine) and
batches of 512, so a run takes seconds on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
N_KEYS = 1 << 14
BATCH = 512


def tiny_f2(n_keys: int) -> dict:
    import dataclasses
    from repro_torch.workload import make_f2_config
    cfg = dataclasses.asdict(make_f2_config(n_keys))
    cfg["engine"] = "fused_ref"
    return cfg


def make_root(tmp: Path, cells=("kv_a_zipf", "kv_c_uniform"),
              batch: int = BATCH) -> Path:
    """tmp/BENCHMARK.json and tmp/f2bench: the real manifest cut to `cells`,
    every configuration at N_KEYS keys, every mix at `batch` lanes."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "f2bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((REPO / "BENCHMARK.json").read_text())
    data["workloads"] = [w for w in data["workloads"] if w["name"] in cells]
    for m in data["per_layer"] + data["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [c for c in m["workloads"] if c in cells]
    for c in data["configs"]:
        f = root / c["file"]
        conf = json.loads(f.read_text())
        conf["n_keys"] = N_KEYS
        conf["load_batch"] = 256
        conf["f2"] = tiny_f2(N_KEYS)
        f.write_text(json.dumps(conf))
    for f in (root / "f2bench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["batch"] = batch
        f.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root
