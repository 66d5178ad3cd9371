#!/usr/bin/env python3
"""Run the reduced dry-run cells of `tests/test_torch_dryrun.py` without
JAX, on whatever PyTorch the machine has (its DTensor refuses other
layouts from one version to the next).

    PYTHONPATH=src python3 tools/dryrun_reduced.py [--out PATH]

On a fake process group of 16 ranks (a 4 x 4 mesh, no device), each
architecture's reduced config in bf16: the decode cells of GLM-4-9B,
Whisper-large-v3, Granite-3-8B and Hymba-1.5B (8 lanes, a cache of 64)
under both cache layouts (`REPRO_DECODE_KV` seq and heads), and the train
and prefill cells of RWKV-6-7B and Hymba-1.5B (8 x 8 tokens), each run
with its recurrence by trip count and unrolled.  It prints one JSON line a
cell (status, error, temporaries, and whether the two counts agree) and
exits non-zero if a cell fails or a pair disagrees.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun, step_trace  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402

DECODE_ARCHS = ("glm4_9b", "whisper_large_v3", "granite_3_8b", "hymba_1_5b")
SCAN_ARCHS = ("rwkv6_7b", "hymba_1_5b")


def cell(arch: str, kind: str, T: int) -> dict:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    return dryrun.run_cell(arch, kind, False, verbose=False, cfg=cfg,
                           shape=ShapeSpec(kind, T, 8, kind), mesh_shape=(4, 4))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the records here")
    args = ap.parse_args(argv)
    import torch
    out = []
    layout = sharding._DECODE_KV
    try:
        for sharding._DECODE_KV in ("seq", "heads"):
            for arch in DECODE_ARCHS:
                r = cell(arch, "decode", 64)
                out.append(dict(arch=arch, kind="decode", layout=sharding._DECODE_KV,
                                ok=r["status"] == "ok", error=r.get("error"),
                                temp=r.get("memory", {}).get("temp_bytes_per_device")))
    finally:
        sharding._DECODE_KV = layout
    for arch in SCAN_ARCHS:
        for kind in ("train", "prefill"):
            a = cell(arch, kind, 8)
            with step_trace.unrolled():
                b = cell(arch, kind, 8)
            ok = a["status"] == b["status"] == "ok"
            out.append(dict(arch=arch, kind=kind, ok=ok,
                            error=a.get("error") or b.get("error"),
                            equal=ok and a["cost"] == b["cost"]
                            and a["collectives"] == b["collectives"]))
    for o in out:
        print(json.dumps(dict(o, torch=torch.__version__)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not all(o["ok"] and o.get("equal", True) for o in out):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
