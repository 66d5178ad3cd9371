#!/usr/bin/env python3
"""Time one checkout's flash-attention kernels at the head dims off the
tensor cores' old widths, on one card.

    python3 tools/flash_ab.py [ROOT] [--out PATH]

ROOT (default: this checkout) is a repository root whose `chip_smoke.py`
has `_device_ms`, `flash_bound` and `KERNEL_FUNCTIONS`, and whose flash
wrapper has `route`, `forward_cuda` and `backward_cuda` (every tree since
the tensor-core slice).  The script builds that tree's flash kernels and
times its `forward_cuda` and `backward_cuda` in bfloat16 on the route that
tree's `route` picks, at two shapes: Dh 512 (B 1, Hkv 8, G 4, T 1,024,
causal; PERF.md rows 5d and 5e) and Dh 96 at the training shape (B 2, Hkv
8, G 4, T 4,096, causal; row 5f): device ms per call from the profiler
(the route's kernels summed), the L2 cache flushed before each call as
`chip_smoke.py` does, beside the bound.  It prints one JSON line.  To
compare two trees, run it in turns on one card (A, B, B, A): each run is its
own process, so the two trees' modules never meet.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (name, B, Hkv, G, T, Dh)
SHAPES = (("dh512", 1, 8, 4, 1024, 512), ("dh96_train", 2, 8, 4, 4096, 96))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?",
                   default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    build.build_all(["flash_attention", "flash_attention_tc"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = dict(root=root)
    for name, B, Hkv, G, T, Dh in SHAPES:
        dt = torch.bfloat16
        BH = B * Hkv
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dt) for s in
                       ((BH, G, T, Dh), (BH, 1, T, Dh), (BH, 1, T, Dh), (BH, G, T, Dh)))
        route = fa_ops.route(dt, Dh)
        o, lse = fa_ops.forward_cuda(q, k, v, True, 0)
        reps = 3 if T >= 4096 else 10
        for kind, fn in (("fwd", lambda: fa_ops.forward_cuda(q, k, v, True, 0)),
                         ("bwd", lambda: fa_ops.backward_cuda(q, k, v, o, lse, do, True, 0))):
            names = cs.KERNEL_FUNCTIONS[f"flash_attention_{kind}_{route}"]
            out[f"{name}_{kind}_device_ms"] = cs._device_ms(
                lambda: (flush.zero_(), fn()), reps, names)
            out[f"{name}_{kind}_bound_ms"] = cs.flash_bound(BH, G, T, T, Dh, dt, True, 0,
                                                            kind == "bwd")[0]
        out[f"{name}_route"] = route
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()[0]
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
