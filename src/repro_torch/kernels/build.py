"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` of a kernel package is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface
(`build/repro_torch_kernels/lib<name>-<hash>.so` at the repository root) and
loaded with `ctypes`.  The file name carries a hash of the sources and flags,
so an edited kernel is rebuilt and an unchanged one is reused.  All sources
are compiled in parallel, one `nvcc` process each (`build_seconds` holds
each one's wall time).

Nothing here runs at import time: the first kernel launch (or an explicit
`build_all()`) builds.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"

# kernel library name -> its source (headers next to it are hashed too)
SOURCES = {
    "fused_probe": KERNELS_DIR / "f2_probe" / "csrc" / "fused_probe.cu",
    "fused_write": KERNELS_DIR / "f2_probe" / "csrc" / "fused_write.cu",
    "paged_attention": KERNELS_DIR / "paged_attention" / "csrc" / "paged_attention.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_tc": KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_tc.cu",
    "wkv6": KERNELS_DIR / "rwkv6_wkv" / "csrc" / "wkv6.cu",
    "probe": KERNELS_DIR / "f2_probe" / "csrc" / "probe.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}     # nvcc/ptxas output of the last build
build_seconds: Dict[str, float] = {}   # wall seconds of each source's nvcc


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(src.parent.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile the named kernels (all by default) that are not built yet, in
    parallel; returns the wall seconds spent.  Raises on any failure."""
    names = list(SOURCES) if names is None else names
    todo = [n for n in names if not lib_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()

    def compile_one(n):
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_seconds[n] = time.perf_counter() - t
        return proc, tmp, out

    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        done = dict(zip(todo, pool.map(compile_one, todo)))
    failed = []
    for n, (proc, tmp, out) in done.items():
        build_log[n] = proc.stdout
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{proc.stdout}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
