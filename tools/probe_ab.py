#!/usr/bin/env python3
"""A/B the F2 store's probe kernels and their wrapper inside one process.

    python3 tools/probe_ab.py PARENT [--log2-keys K] [--log2-ops N]
                              [--rounds R] [--out PATH]

PARENT is a checkout of another tree of this repository (every tree since
the store was ported).  The script loads one store of this checkout at
2**K keys (default 24, as `chip_smoke.py` runs it) and then runs YCSB-A,
-B and -F of about 2**N ops each (every read checked) through four
variants of the probe path, in turns on that one store:

  parent   PARENT's `f2_probe/ops.py` wrappers on PARENT's kernels
  kernel   PARENT's wrappers on this checkout's kernels
  wrapper  this checkout's wrappers on PARENT's kernels
  change   this checkout's wrappers on this checkout's kernels

"Kernels" are the `fused_probe` and `fused_write` libraries, which share
`f2_common.cuh`; each tree's are compiled from its own sources with this
checkout's nvcc flags.  A variant is switched in by pointing this
checkout's `ops.fused_probe` and `ops.fused_write` (which the store calls)
at a module copy of that variant's `ops.py` bound to that variant's
libraries.  Each round runs every variant once, the order rotated by one
place a round, so each variant takes each place equally often over four
rounds.  Each variant's wrapper is also timed on `chip_smoke.probe_cases`'
first case (B 8192 reads through the hot index): host us per call (200
calls back to back) and device ms per call (profiler).  Prints one JSON
line per round and a summary line with each variant's median ops/s per
mix.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("parent", "kernel", "wrapper", "change")
LIBS = ("fused_probe", "fused_write")


def _compile(build, src: str, out: str) -> None:
    if os.path.exists(out):
        return
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", tmp, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def _ops_module(path: str, tag: str, libs):
    """A copy of an `f2_probe/ops.py` in this checkout's package, whose
    `build.load` returns the given libraries."""
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.kernels.f2_probe._ab_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "repro_torch.kernels.f2_probe"
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(load=lambda name: libs[name])
    return mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("parent")
    p.add_argument("--log2-keys", type=int, default=24)
    p.add_argument("--log2-ops", type=int, default=21)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    parent = os.path.abspath(a.parent)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import KV
    from repro_torch.kernels import build
    from repro_torch.kernels.f2_probe import ops, ref
    from repro_torch.workload import Zipf, make_f2_config

    build.build_all(["fused_probe", "fused_write", "probe"])
    csrc = os.path.join(parent, "src", "repro_torch", "kernels", "f2_probe", "csrc")
    libs = {
        "change": {n: ctypes.CDLL(str(build.lib_path(n))) for n in LIBS},
        "parent": {},
    }
    for n in LIBS:
        out = str(build.BUILD_DIR / f"lib{n}-ab-parent.so")
        _compile(build, os.path.join(csrc, f"{n}.cu"), out)
        libs["parent"][n] = ctypes.CDLL(out)
    ops_py = {"parent": os.path.join(parent, "src", "repro_torch", "kernels", "f2_probe",
                                     "ops.py"),
              "change": os.path.join(ROOT, "src", "repro_torch", "kernels", "f2_probe",
                                     "ops.py")}
    mods = {v: _ops_module(ops_py[w], v, libs[k]) for v, w, k in (
        ("parent", "parent", "parent"), ("kernel", "parent", "change"),
        ("wrapper", "change", "parent"), ("change", "change", "change"))}

    def use(v):
        ops.fused_probe = mods[v].fused_probe
        ops.fused_write = mods[v].fused_write

    n_keys, n_ops = 1 << a.log2_keys, 1 << a.log2_ops
    cfg = make_f2_config(n_keys, engine="fused")
    V = cfg.value_width
    rng = np.random.default_rng(cs.SEED)
    use("change")
    kv = KV(cfg, device="cuda")
    t0 = time.perf_counter()
    cs.load_keys(kv, rng.permutation(n_keys).astype(np.int32), V)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    expect = cs.val_of(np.arange(n_keys), V)
    zipf = Zipf(n_keys, 0.99)

    _, args, kw = cs.probe_cases(kv, np.random.default_rng(cs.SEED + 1), n_keys)[0]
    want = ref.fused_probe_body(*args, early_exit=True, **kw)
    wrapper = {}
    for v in VARIANTS:
        fn = mods[v].fused_probe
        got = fn(*args, **kw)
        if cs._max_abs_err(got, want) != 0:
            raise AssertionError(f"{v}: fused_probe differs from its plain version")
        # "fused_probe" names both trees' kernels (fused_probe_kernel,
        # fused_probe_walk_kernel)
        wrapper[v] = dict(host_us=cs._host_us(lambda: fn(*args, **kw), 200),
                          device_ms=cs._device_ms(lambda: fn(*args, **kw), 20,
                                                  ("fused_probe",)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    rates = {v: {wl: [] for wl in "ABF"} for v in VARIANTS}
    lines = []
    for r in range(a.rounds):
        order = VARIANTS[r % 4:] + VARIANTS[:r % 4]
        rec = dict(round=r, order=order)
        for v in order:
            use(v)
            for wl in "ABF":
                ops_s, _ = cs.ycsb(kv, expect, wl, n_ops, zipf, rng)
                rates[v][wl].append(ops_s)
                rec[f"{v}_{wl}"] = ops_s
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    use("change")
    kv.check_invariants()
    summary = dict(card=smi, n_keys=n_keys, n_ops=n_ops, rounds=a.rounds, load_s=load_s,
                   wrapper_read_index=wrapper,
                   median_ops_per_s={v: {wl: statistics.median(x) for wl, x in m.items()}
                                     for v, m in rates.items()})
    print(json.dumps(summary))
    if a.out:
        with open(a.out, "a") as f:
            for rec in lines + [summary]:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
