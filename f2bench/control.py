"""The control of the check: the plain reference put in the program's
place with one stated guarantee broken, run through the whole harness at a
cell's own size, which its check has to find not correct.

    python3 f2bench/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3]

The broken reference (`reference.DenseStore(narrow=True)`) stores value
words in int16, the nearest integer width below the configuration's exact
31-bit words; it breaks `exact_values`.  One line per seed: the check's
numbers and whether the run came out correct (it must not).  Not run by
the benchmark's own runs; it needs the card, as they do.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def narrow_store(run):
    from f2bench.reference import DenseStore
    return DenseStore(run.n_keys, run.V, run.seed, run.device, narrow=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from f2bench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = harness.Run(ROOT, args.workload, seed, args.seconds, False,
                          device="cuda", store_factory=narrow_store)
        run.setup()
        run.window()
        rec = run.finish()
        check = rec["check"]
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": harness.is_correct(check),
                          "batches": rec["window_batches"],
                          "check": harness.limits(check)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
