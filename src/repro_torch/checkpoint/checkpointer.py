"""Async, atomic checkpointing (the JAX package's `checkpoint/
checkpointer.py`, over PyTorch tensors).

Layout: <dir>/step_<N>/leaves.bin + manifest.json (written LAST — a
checkpoint without a manifest is incomplete and ignored on restore).
`leaves.bin` is every leaf's .npy serialization back to back; the manifest
carries each leaf's path, byte offset and torch dtype.  bfloat16 leaves,
which numpy cannot hold, are stored as their int16 bit patterns.
Saving runs on a background thread off the step path, from a host copy
taken before the call returns; exceptions raised there are surfaced on the
next `save()`/`wait()` instead of vanishing.

Commit is a rename swap: the finished `.tmp_step_N` is renamed over the
final name after any previous `step_N` is renamed aside to `.old_step_N`
(then deleted).  A crash can therefore never lose a previously committed
step: the worst case leaves `.old_step_N` behind, which `__init__`
promotes back to `step_N` if the final name is missing.  Stale
`.tmp_step_*` / `.old_step_*` and manifest-less `step_N` dirs are ignored
by `available_steps()`/`restore()` and garbage-collected.

A state is a tree of dicts, NamedTuples (the port's `TrainState` and
`OptState`), `nn.Module`s (their named parameters) and tensors.  `restore`
copies the leaves into the tensors of `like`, in place, so a model-sized
state is never held twice on the device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..testing import faults

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointStructureError(AssertionError):
    """Restore target structure does not match the checkpoint manifest.

    Subclasses AssertionError, as the reference's does."""

    def __init__(self, step: int, like_paths, ckpt_paths):
        missing = [p for p in ckpt_paths if p not in like_paths]
        extra = [p for p in like_paths if p not in ckpt_paths]
        msg = (f"checkpoint/model structure mismatch at step {step}: "
               f"{len(like_paths)} target leaves vs "
               f"{len(ckpt_paths)} checkpointed leaves")
        if missing:
            msg += f"; in checkpoint but not target: {missing}"
        if extra:
            msg += f"; in target but not checkpoint: {extra}"
        super().__init__(msg)
        self.step = step
        self.missing = missing
        self.extra = extra


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of `tree`, in a fixed order."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(join(n), p) for n, p in tree.named_parameters()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in leaves(getattr(tree, f), join(f))]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, join(k))]
    raise TypeError(f"checkpoint leaf {prefix!r}: {type(tree).__name__} is not a tensor")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.capture_s = 0.0    # the last save's host copy (its stall)
        self._repair()

    # -- crash repair ----------------------------------------------------------
    def _repair(self):
        """Promote `.old_step_N` left by a crash mid-swap; GC torn artifacts."""
        for d in os.listdir(self.dir):
            m = re.match(r"^\.old_step_(\d+)$", d)
            if not m:
                continue
            final = os.path.join(self.dir, f"step_{m.group(1)}")
            if not os.path.exists(final):
                os.rename(os.path.join(self.dir, d), final)
        self._gc_torn()

    def _gc_torn(self):
        for d in os.listdir(self.dir):
            p = os.path.join(self.dir, d)
            if d.startswith(".tmp_step_") or d.startswith(".old_step_"):
                shutil.rmtree(p, ignore_errors=True)
            elif _STEP_RE.match(d) and not os.path.exists(
                    os.path.join(p, "manifest.json")):
                shutil.rmtree(p, ignore_errors=True)

    # -- save ------------------------------------------------------------------
    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Any, blocking: bool = False,
             on_commit: Optional[Callable[[], None]] = None):
        """Write `state` as step `step` on the worker thread.  `on_commit`
        runs there after the manifest commits (housekeeping that must wait
        until the checkpoint is durable, such as WAL segment GC); its errors
        surface like the save's."""
        # a host copy BEFORE going async: the step path updates the state
        # in place
        t0 = time.perf_counter()
        host = [(p, str(t.dtype), _to_numpy(t)) for p, t in leaves(state)]
        self.capture_s = time.perf_counter() - t0
        if self._thread is not None:
            self._thread.join()
        self._raise_pending()

        def work():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                final = os.path.join(self.dir, f"step_{step}")
                old = os.path.join(self.dir, f".old_step_{step}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                offsets = []
                with open(os.path.join(tmp, "leaves.bin"), "wb") as lf:
                    for _, _, arr in host:
                        offsets.append(lf.tell())
                        np.lib.format.write_array(lf, arr, allow_pickle=False)
                faults.maybe_crash("checkpoint.before_manifest")
                manifest = {"step": step, "leaves": [p for p, _, _ in host],
                            "offsets": offsets, "dtypes": [d for _, d, _ in host]}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                # rename-swap commit: never a window with no step_N on disk
                shutil.rmtree(old, ignore_errors=True)
                if os.path.exists(final):
                    os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
                self._gc()
                if on_commit is not None:
                    on_commit()
            except BaseException as e:   # surfaced on next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        self._raise_pending()

    def _gc(self):
        steps = sorted(self.available_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        self._gc_torn()

    # -- restore ---------------------------------------------------------------
    def available_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None,
                resizable=()) -> Tuple[Any, int]:
        """Copy checkpoint `step` (the latest by default) into the tensors
        of `like`, in place; returns (like, step).  A leaf whose path is in
        `resizable` takes the checkpoint's shape (its tensor is resized in
        place): a variable-length array such as a host chunk store."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        targets = leaves(like)
        paths = [p for p, _ in targets]
        if paths != manifest["leaves"]:
            raise CheckpointStructureError(step, paths, manifest["leaves"])
        dtypes = manifest.get("dtypes", [None] * len(paths))
        with open(os.path.join(d, "leaves.bin"), "rb") as lf:
            for (path, t), off, dt in zip(targets, manifest["offsets"], dtypes):
                lf.seek(off)
                src = torch.from_numpy(np.lib.format.read_array(lf, allow_pickle=False))
                if dt == str(torch.bfloat16):
                    src = src.view(torch.bfloat16)
                if path in resizable and src.dtype == t.dtype:
                    t.resize_(src.shape)
                if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                    raise CheckpointStructureError(
                        step, [f"{path} {t.dtype} {tuple(t.shape)}"],
                        [f"{path} {src.dtype} {tuple(src.shape)}"])
                t.copy_(src)
        return like, step
