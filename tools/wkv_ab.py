#!/usr/bin/env python3
"""Time one checkout's WKV forward kernel and RWKV-6 prefill on one card.

    python3 tools/wkv_ab.py [ROOT] [--out PATH]

ROOT (default: this checkout) is a repository root whose `chip_smoke.py`
has `rwkv_prefill`, `_device_ms` and `KERNEL_FUNCTIONS` (every tree since
the RWKV-6 slice).  The script builds that tree's WKV kernels and times its
`forward_cuda` at the shapes its main paths call: training (B 2, H 64,
T 4096, D 64, saving the states the gradient needs), prefill (B 8, H 64,
T 1024) and decode (B 8, H 64, T 1, from a state, with the final state):
device ms per call from the profiler, the L2 cache flushed before each
call as `chip_smoke.py` does (decode also without the flush).  Then it runs that tree's `rwkv_prefill`
(RWKV-6-7B, 32 layers, 8 prompts of 1024 tokens, random weights from the
seed) and reports its warm wall seconds.  It prints one JSON line.  To
compare two trees, run it in turns on one card (A, B, B, A): each run is
its own process, so the two trees' modules never meet.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = (("train", 2, 64, 4096, 64, False, True),      # (name, B, H, T, D, state, saved states)
          ("prefill", 8, 64, 1024, 64, False, False),
          ("decode", 8, 64, 1, 64, True, False))


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
        print("wkv_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import transformer

    build.build_all(["wkv6"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = dict(root=root)
    for name, B, H, T, D, state, saved in SHAPES:
        r, k, v = (torch.randn((B, H, T, D), generator=g, device=dev) for _ in range(3))
        w = 0.8 + 0.199 * torch.rand((B, H, T, D), generator=g, device=dev)
        u = torch.randn((H, D), generator=g, device=dev)
        s0 = torch.randn((B, H, D, D), generator=g, device=dev) if state else None

        def call():
            flush.zero_()
            wkv_ops.forward_cuda(r, k, v, w, u, s0, state, checkpoints=saved)

        out[f"{name}_device_ms"] = cs._device_ms(call, 3 if T >= 4096 else 20,
                                                 cs.KERNEL_FUNCTIONS["wkv_forward"])
        if name == "decode":   # the state warm in L2, as a decode step can find it
            out["decode_warm_l2_device_ms"] = cs._device_ms(
                lambda: wkv_ops.forward_cuda(r, k, v, w, u, s0, state), 20,
                cs.KERNEL_FUNCTIONS["wkv_forward"])
        del r, k, v, w, u, s0
    del flush
    torch.cuda.empty_cache()
    cfg = cs.rwkv_config()
    model = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev)
    records = []
    rec = cs.rwkv_prefill(cfg, model, "cuda", cs.SEED, records)
    out.update(prefill_warm_wall_s=rec["warm_wall_s"], prefill_wall_s=rec["wall_s"])
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
