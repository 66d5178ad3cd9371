"""A later change adds a configuration, a traffic mix, a metric and a cell
by adding files and entries only: in a copy of the benchmark, new files
under `configs/`, `traffic/` and `metrics/` and new entries in
BENCHMARK.json are found by name and run, with no file of the harness
edited."""
import json

import tiny
from f2bench import harness, manifest


def test_added_files_are_found_and_run(tmp_path):
    root = tiny.make_root(tmp_path, cells=("kv_a_zipf",))
    bench = root / "f2bench"
    conf = json.loads((bench / "configs" / "f2_kv_10pct.json").read_text())
    conf["n_keys"] = tiny.N_KEYS // 2
    conf["f2"] = tiny.tiny_f2(tiny.N_KEYS // 2)
    (bench / "configs" / "f2_kv_small.json").write_text(json.dumps(conf))
    (bench / "traffic" / "ycsb_b_uniform.json").write_text(json.dumps({
        "mix": {"read": 0.95, "upsert": 0.05}, "keys": {"dist": "uniform"},
        "batch": 256}))
    (bench / "metrics" / "batches_per_s.py").write_text(
        "def read(rec):\n"
        "    return rec['window_batches'] / rec['window_s']\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "f2_kv_small",
                            "source": "https://arxiv.org/abs/2305.01516",
                            "file": "f2bench/configs/f2_kv_small.json",
                            "reduced": ["n_keys"], "why": "a test"})
    data["workloads"].append({"name": "kv_b_small", "config": "f2_kv_small",
                              "traffic": "ycsb_b_uniform", "chips": 1,
                              "why": "a test"})
    data["end_to_end"].append({"name": "batches_per_s", "unit": "batches/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["kv_b_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    assert manifest.problems(data) == []

    run = harness.Run(root, "kv_b_small", 99, 1.0, False, device="cpu")
    run.setup()
    run.window()
    rec = run.finish()
    out = harness.result(manifest.load(root), run.cell, rec, False,
                         {"platform": "cpu"})
    assert out["correct"]
    assert out["metrics"]["batches_per_s"]["value"] > 0
    assert "ops_per_s" in out["metrics"] and "setup_s" in out["metrics"]
    assert rec["n_keys"] == tiny.N_KEYS // 2 and rec["batch"] == 256
    assert list(out)[-1] == "check"
