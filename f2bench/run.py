"""Run one cell of the benchmark on the card and print its result line.

    python3 f2bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root.  With `--trace 0` the line holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics (the store's
observability on, the profiler over a few sub-windows).  The check's
numbers and limits end standard error and the line's `check` key.

Exits non-zero, with no result, where CUDA is absent or has fewer cards
than the cell asks for, where the program cannot be imported, or where
JAX, its libraries or the JAX package were loaded by the time the window
closed.  Kernel builds go to `build/repro_torch_kernels/` inside the
checkout (the program's fixed place); any other cache this process could
write is pointed inside the checkout too.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "f2bench_cache"


def _environment():
    """Caches at fixed paths inside the checkout; nothing loads JAX."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from f2bench import harness, manifest

    bench = manifest.load(ROOT)
    cell = bench.cell(args.workload)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"f2bench: the program is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("f2bench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"f2bench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    run = harness.Run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    run.setup()
    run.window()
    bad = harness.forbidden_loaded()
    if bad:
        print(f"f2bench: the process holds {bad} after the window",
              file=sys.stderr)
        return 3
    rec = run.finish()
    device = harness.device_info(rec, cell["chips"], bool(args.trace))
    device["power"] = power_limit()
    out = harness.result(bench, cell, rec, bool(args.trace), device)
    print(f"f2bench: {cell['name']} seed {args.seed}: window "
          f"{rec['window_s']:.3f} s, {rec['window_batches']} batches, "
          f"set-up {rec['setup_s']:.3f} s, check {rec['check_s']:.3f} s, "
          f"profiler {rec.get('profiler_overhead_s', 0):.3f} s, compaction "
          f"spans {rec.get('compact_s', 0):.3f} s", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
