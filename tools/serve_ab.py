#!/usr/bin/env python3
"""Profile the Granite-3-8B decode step of one checkout of this repository.

    python3 tools/serve_ab.py [ROOT] [--prompt-tokens N] [--out PATH]

ROOT (default: this checkout) is a repository root whose `chip_smoke.py`
has `SERVE_ARCH`, `SERVE_LAYERS`, `SEED`, `make_engine` and `serve_profile`
(every tree since the paged serving path was ported).  The script builds
that tree's paged-attention kernel, makes the serve phase's engine (random
weights from the seed, SERVE_LAYERS deep at full width) and runs that tree's
`serve_profile`: 8 full decode steps of 8 lanes under the profiler, after
prompts of N tokens (default: that tree's SERVE_PROMPT_MIN; 200 puts 13
pages of 16 in every lane's table, as the serve phase's lanes hold).  It
prints one JSON line: the card, ms per step, device busy ms per step, the
idle share, and the paged-attention kernels' device ms per step and per
call.  To compare two trees, run it in turns on one card (A, B, B, A): each
run is its own process, so the two trees' modules never meet.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?",
                   default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--prompt-tokens", type=int, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_config

    if a.prompt_tokens:
        cs.SERVE_PROMPT_MIN = a.prompt_tokens
    build.build_all(["paged_attention"])
    cfg = dataclasses.replace(get_config(cs.SERVE_ARCH), n_layers=cs.SERVE_LAYERS)
    model = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(cs.SEED), "cuda")
    eng = cs.make_engine(cfg, model, "cuda")
    # serve_profile admits and prefills 8 prompts (the warm-up) before its
    # window
    rec = cs.serve_profile(eng, cs.SEED, [])
    steps = rec["steps"]
    paged = sum(r["s"] for r in rec["paged_attention"])
    calls = max((r["calls"] for r in rec["paged_attention"]), default=0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out = dict(root=root, card=smi, layers=cfg.n_layers, steps=steps,
               prompt_tokens=cs.SERVE_PROMPT_MIN,
               ms_per_step=rec["ms_per_step"],
               device_busy_ms_per_step=rec["device_busy_s"] / steps * 1e3,
               device_idle_share=rec["device_idle_share"],
               launches_per_step=rec["launches_per_step"],
               paged_device_ms_per_step=paged / steps * 1e3,
               paged_device_ms_per_call=paged / calls * 1e3 if calls else "not measured",
               paged_kernels=rec["paged_attention"])
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
