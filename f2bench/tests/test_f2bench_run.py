"""`run.py` fails, with no result line, where it cannot measure: here,
without a card, and in a checkout that holds only the benchmark."""
import shutil
import subprocess
import sys

from conftest import ROOT

ARGS = ["--workload", "kv_c_zipf", "--seed", str(2 ** 31 + 5), "--seconds",
        "1", "--trace", "0"]


def run_py(root):
    return subprocess.run([sys.executable, str(root / "f2bench" / "run.py"),
                           *ARGS], capture_output=True, text=True, cwd=root,
                          timeout=300, env={"PATH": "/usr/bin:/bin",
                                            "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "f2bench", tmp_path / "f2bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "not importable" in out.stderr
