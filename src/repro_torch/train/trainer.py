"""Fault-tolerant training loop (the JAX package's `train/trainer.py`).

  * checkpoint/restart: async checkpoints every `ckpt_every`; on (re)start
    the trainer resumes from the latest complete manifest and the data
    pipeline replays deterministically from that step;
  * straggler watchdog: per-step wall time vs an EMA; slow steps are logged
    as straggler events;
  * failure injection: `fail_at_step` raises mid-run, for restart tests.

The trainer runs on the CUDA device unless the caller passes another
`device`.  With a `mesh` (a DeviceMesh) its steps run under it
(`distributed.sharding.use_mesh`): the model's expert-parallel branch and
its layout constraints see the mesh.  A step's wall time ends when its loss
reaches the host.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import ModelConfig
from ..core.api import resolve_device
from ..data.pipeline import TokenPipeline
from ..distributed.sharding import use_mesh
from ..optim import adamw
from . import train_step as ts


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None       # None: default_ckpt_dir()
    watchdog_factor: float = 3.0   # step > factor * EMA => straggler event
    log_every: int = 10
    microbatches: int = 1
    fail_at_step: Optional[int] = None   # failure injection (tests)


class Trainer:
    def __init__(self, cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                 tcfg: TrainerConfig, pipeline: TokenPipeline, device=None,
                 mesh=None):
        self.device = resolve_device(device, "repro_torch.train.Trainer")
        self.mesh = mesh
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.pipeline = pipeline
        self.ckpt = Checkpointer(tcfg.ckpt_dir or default_ckpt_dir())
        self._step = ts.make_train_step(cfg, ocfg, microbatches=tcfg.microbatches)
        self.straggler_events: List[Dict] = []
        self.metrics_log: List[Dict] = []

    def init_or_restore(self, seed: int = 0) -> ts.TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = ts.init_state(self.cfg, self.ocfg, gen, self.device)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, step = self.ckpt.restore(state)
            print(f"[trainer] restored step {step} from {self.ckpt.dir}")
        return state

    def run(self, state: Optional[ts.TrainState] = None) -> ts.TrainState:
        if state is None:
            state = self.init_or_restore()
        start = int(state.step)
        ema = None
        for step in range(start, self.tcfg.total_steps):
            if self.tcfg.fail_at_step is not None \
                    and step == self.tcfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            t0 = time.perf_counter()
            with use_mesh(self.mesh):
                state, metrics = self._step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > self.tcfg.watchdog_factor * ema and step > start + 3:
                self.straggler_events.append({"step": step, "dt": dt,
                                              "ema": ema})
            if step % self.tcfg.log_every == 0:
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "dt_s": dt}
                self.metrics_log.append(rec)
                print(f"[trainer] step {step} loss {rec['loss']:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        self.ckpt.save(self.tcfg.total_steps, state, blocking=True)
        return state
