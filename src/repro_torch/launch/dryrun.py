"""Dry-run: lay out every (architecture x input shape) cell on the
production meshes and trace one step of it (the JAX package's
`launch/dryrun.py`, which lowers and compiles on 512 virtual devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cell glm4_9b:decode_32k --cell rwkv6_7b:train_4k

It runs on no device.  The process joins a fake process group of the
mesh's size (every collective returns at once), the weights, optimizer
state, caches and batch are `meta` DTensors laid out by the port's specs,
and the step runs once, eagerly, on the port's plain paths (a meta tensor
is no CUDA tensor, so every kernel wrapper takes its plain version), under
`step_trace.StepTrace`.  Each record holds:

  * memory per device: the arguments' local shards, the outputs' local
    shards, the temporaries (the peak of the live local tensors the step
    creates, `step_trace.StepTrace`: an eager peak, not XLA's buffer
    assignment) and their total, arguments + temporaries;
  * FLOPs and matmul operand bytes per device, counted on the local shards
    (a recurrence's step counted by its trip count, `step_trace.repeat`);
  * the collectives as the step asked for them, with the ring formulas'
    link bytes (`comm_analysis`), and the three roofline terms on the H100
    SXM's datasheet figures;
  * the model FLOPs (6ND train, 2ND prefill and decode).

A cell whose step raises is recorded as `failed` with its error, and the
run exits non-zero; a cell the assignment rules skip is `skipped`.
"""
from __future__ import annotations

import argparse
import json
import signal
import time
import traceback
from typing import Optional

import torch

from ..configs.base import ALL_SHAPES, shape_applicable
from ..distributed import param_sharding
from ..distributed.sharding import placements, use_mesh
from ..models.registry import ARCH_IDS, get_config
from ..optim.adamw import AdamWConfig
from ..serve import serve_step as ss
from ..train import train_step as ts
from . import comm_analysis, specs, step_trace
from .mesh import make_mesh, make_production_mesh

DEVICE = "meta (no device: a fake process group of the mesh's size)"


def fake_world(world_size: int):
    """Join a fake process group of `world_size` ranks (as rank 0), leaving
    any other group first.  `fake_pg` is a private module of PyTorch: the
    dry-run fails loudly where it is missing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _dist(t: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh))


def build_cell(arch: str, shape_name: str, mesh, ocfg=None,
               device_memory: float = specs.H100_MEMORY, cfg=None, shape=None):
    """(fn, args) of one cell: `fn(*args)` runs its step on meta DTensors
    laid out over `mesh` by the port's specs (`cfg`, `shape`: a config and a
    ShapeSpec in place of the registry's)."""
    cfg = cfg or get_config(arch)
    shape = shape or specs.SHAPES[shape_name]
    ocfg = ocfg or AdamWConfig(state_dtype="bfloat16")
    batch, bspecs = specs.input_specs(cfg, shape, mesh)
    batch = {k: _dist(v, bspecs[k], mesh) for k, v in batch.items()}
    if shape.kind == "train":
        state, sspecs = specs.train_state_specs(cfg, ocfg, mesh)
        param_sharding.distribute_params(state.params, mesh)
        opt = state.opt
        opt = opt._replace(
            mu={n: _dist(t, sspecs.opt.mu[n], mesh) for n, t in opt.mu.items()},
            nu={n: _dist(t, sspecs.opt.nu[n], mesh) for n, t in opt.nu.items()},
            err={n: _dist(t, sspecs.opt.err[n], mesh) for n, t in opt.err.items()},
            count=_dist(opt.count, (), mesh))
        state = ts.TrainState(params=state.params, opt=opt,
                              step=_dist(state.step, (), mesh))
        return ts.make_train_step(cfg, ocfg, remat=True), (state, batch)
    model = specs.meta_model(cfg)
    param_sharding.distribute_params(
        model, mesh, rules=specs.serve_rules(cfg, mesh, device_memory))
    if shape.kind == "prefill":
        return (lambda m, b: ss.prefill_step(cfg, m, b)), (model, batch)
    cache, cspecs = specs.cache_state_specs(cfg, shape, mesh)
    cache = {k: _dist(v, cspecs[k], mesh) for k, v in cache.items()}
    return ((lambda m, c, t: ss.decode_step(cfg, m, c, t)),
            (model, cache, batch["tokens"]))


def _tensors(x):
    """Every tensor of a nest of modules, dicts and (named) tuples."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


TEMP_BYTES_METHOD = ("peak of the live local shards the eager step creates "
                     "(step_trace.StepTrace), not XLA's buffer assignment: "
                     "expect it above the reference's")


def memory_record(arg_bytes: int, args, out, trace) -> dict:
    """Bytes per device of a traced step, as the reference reports them:
    arguments, outputs (the results that are not arguments), temporaries
    (the trace's peak of live tensors it saw created) and total = arguments
    + temporaries."""
    out_tensors = [t for t in _tensors(out)
                   if not any(t is a for a in _tensors(args))]
    return {
        "argument_bytes_per_device": arg_bytes,
        "output_bytes_per_device": step_trace.local_bytes(out_tensors),
        "temp_bytes_per_device": trace.temp_peak,
        "temp_bytes_method": TEMP_BYTES_METHOD,
        "total_bytes_per_device": arg_bytes + trace.temp_peak,
    }


class CellTimeout(Exception):
    pass


def _on_alarm(signum, frame):
    raise CellTimeout("the traced step ran past the cell's time limit")


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             device_memory: float = specs.H100_MEMORY, *, cfg=None, shape=None,
             mesh_shape: Optional[tuple] = None,
             timeout_s: Optional[int] = None) -> dict:
    """One cell's record.  `cfg`, `shape` and `mesh_shape` (over ("data",
    "model")) replace the registry's config, the named shape and the
    production mesh (tests run reduced cells on small fake groups).  A step
    still running after `timeout_s` seconds fails the cell."""
    cfg = cfg or get_config(arch)
    shape = shape or specs.SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    n_dev = (mesh_shape[0] * mesh_shape[1] if mesh_shape
             else 512 if multi_pod else 256)
    t0 = time.time()
    if timeout_s:
        old_handler = signal.signal(signal.SIGALRM, _on_alarm)
        signal.alarm(int(timeout_s))
    try:
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.distributed.tensor.experimental import implicit_replication
        fake_world(n_dev)
        mesh = (make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
                if mesh_shape else
                make_production_mesh(multi_pod=multi_pod, device_type="cpu"))
        with use_mesh(mesh), implicit_replication():
            fn, args = build_cell(arch, shape_name, mesh,
                                  device_memory=device_memory, cfg=cfg,
                                  shape=shape)
            arg_bytes = step_trace.local_bytes(_tensors(args))
            trace = step_trace.StepTrace(mesh)
            comm = CommDebugMode()
            with comm, trace:
                out = fn(*args)
        summary = trace.summary()
        flops = float(trace.flops)
        hbm = float(trace.op_bytes)
        roof = comm_analysis.roofline_terms(flops, hbm, summary, n_dev)
        rec = {
            "arch": arch, "shape": shape_name, "status": "ok",
            "mesh": list(mesh.shape), "n_devices": n_dev, "device": DEVICE,
            "compile_s": round(time.time() - t0, 1),
            "memory": memory_record(arg_bytes, args, out, trace),
            "cost": {"flops_per_device": flops, "hbm_bytes_per_device": hbm},
            "collectives": summary,
            "comm_debug_counts": {str(k): int(v) for k, v in
                                  comm.get_comm_counts().items()},
            "roofline": roof,
            "model_flops": model_flops(arch, shape_name, cfg, shape),
        }
        if verbose:
            mem = rec["memory"]
            print(f"[{arch} x {shape_name} x {n_dev}d] OK {rec['compile_s']}s |"
                  f" {mem['argument_bytes_per_device'] / 2**30:.2f} GiB/dev args"
                  f" + {mem['temp_bytes_per_device'] / 2**30:.2f} temp |"
                  f" {flops / 1e9:.1f} GF/dev | coll"
                  f" {summary['intra_node_bytes'] / 2**20:.1f} MiB nvlink"
                  f" +{summary['inter_node_bytes'] / 2**20:.1f} MiB inter-node |"
                  f" dominant={roof['dominant']}", flush=True)
        return rec
    except Exception as e:  # noqa: BLE001 -- the dry-run reports failures
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "status": "failed",
                "error": f"{type(e).__name__}: {e}",
                "compile_s": round(time.time() - t0, 1)}
    finally:
        if timeout_s:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old_handler)


def model_flops(arch: str, shape_name: str, cfg=None, shape=None) -> float:
    """MODEL_FLOPS: 6*N*D train (N = active params, D = tokens); 2*N*D
    prefill; 2*N per lane decode."""
    cfg = cfg or get_config(arch)
    shape = shape or specs.SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all four)")
    ap.add_argument("--all", action="store_true",
                    help="every architecture and shape (the default when "
                         "neither --arch nor --shape is given)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 devices) instead of 16x16")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--device-memory", type=float, default=specs.H100_MEMORY,
                    help="device bytes the serving layout plans for")
    ap.add_argument("--cell-timeout", type=int, default=600,
                    help="seconds a cell's step may run before it fails")
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE",
                    help="one cell (repeatable; in place of --arch/--shape)")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES] if args.all or not args.shape
              else [args.shape])
    cells = ([tuple(c.split(":", 1)) for c in args.cell] if args.cell and not args.all
             else [(a, s) for a in archs for s in shapes])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for mp in meshes:
        for arch, shape in cells:
            records.append(run_cell(arch, shape, mp, device_memory=args.device_memory,
                                    timeout_s=args.cell_timeout))
            if args.out:                # every record as soon as it exists
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fail = sum(r["status"] == "failed" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed"
          f" / {len(records)} cells ({DEVICE})")
    if args.out:
        print("wrote", args.out)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
