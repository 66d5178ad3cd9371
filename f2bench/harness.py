"""One run of one cell: set-up, the timed window, the traced sub-windows,
the check against the reference, and the result line.

Everything that belongs to one cell is found by name under the benchmark's
folder (see `manifest`): the configuration builds the store through its
facade module, the traffic file parametrises `gen.Traffic`, and each metric
is a reader module that takes the run's record.  The program under test is
`repro_torch`; the harness hands it generated `keys`, `ops` and `vals`
tensors and takes back statuses and values.

The loop is closed, in YCSB's model of clients that each wait for their op:
a batch of B ops is submitted once its inputs are on the device, and the
next goes when its statuses and values are on the host (frozen from
`chip_smoke.py`'s `ycsb()`: apply, result copy, synchronize, host clock).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from f2bench import gen, manifest, profiling
from f2bench.reference import Checker, DenseStore

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
PROFILE_AT = (0.2, 0.5, 0.8)       # traced sub-windows, as window fractions
PROFILE_BATCHES = 4                # batches in each traced sub-window
WARMUP_BATCHES = 4                 # the cell's batch shape, run in set-up
CHECK_LANES = 8192                 # value rows of a batch kept for the check
# The program's counters are int32 and wrap within a window of 2M-lane
# batches; one batch's delta, taken modulo this, is far below it.
COUNTER_WRAP = 1 << 32
KERNEL_LIBS = ("fused_probe", "fused_write", "probe")


def forbidden_loaded(modules=None) -> list:
    """Top-level names in `modules` (sys.modules) that the benchmark's
    process must not hold, compared whole: `repro_torch` is not `repro`."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def f2_config(conf: dict):
    """The configuration file's explicit `F2Config` fields."""
    from repro_torch import F2Config
    fields = {f.name for f in dataclasses.fields(F2Config)}
    unknown = set(conf["f2"]) - fields
    if unknown:
        raise ValueError(f"unknown F2Config fields {sorted(unknown)}")
    return F2Config(**conf["f2"])


class Run:
    """A cell's run on `device` ("cuda" for a measurement; "cpu" only in
    tests, at a tiny size).  `wrap`, if given, wraps the store the facade
    builds (the tests' broken stores); `store_factory` puts another store
    in the program's place (the control)."""

    def __init__(self, root, cell: str, seed: int, seconds: float,
                 trace: bool, device="cuda", wrap=None, store_factory=None,
                 t_start=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.bench = manifest.load(root)
        self.cell = self.bench.cell(cell)
        self.conf = self.bench.config(self.cell["config"])
        self.mix = self.bench.traffic(self.cell["traffic"])
        self.facade = self.bench.facade(self.conf["facade"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.wrap, self.store_factory = wrap, store_factory
        self.counted, self._last_count = None, None
        self.n_keys = int(self.conf["n_keys"])
        self.V = int(self.conf["f2"]["value_width"])
        self.rec = dict(cell=cell, seed=self.seed, seconds=self.seconds,
                        n_keys=self.n_keys, value_width=self.V,
                        batch=int(self.mix["batch"]),
                        device_kind=(torch.cuda.get_device_name(self.device)
                                     if self.cuda else None))

    # -- set-up ---------------------------------------------------------------
    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup(self):
        if self.cuda:
            from repro_torch.kernels import build
            build.build_all(list(KERNEL_LIBS))
        if self.store_factory is not None:
            self.store = self.store_factory(self)
        else:
            self.store = self.facade.build(f2_config(self.conf), self.conf,
                                           self.mix, self.device)
            self._load()
        if self.wrap is not None:
            self.store = self.wrap(self.store)
        self.traffic = gen.Traffic(self.mix, self.n_keys, self.V, self.seed,
                                   self.device)
        self.checker = Checker(self.traffic, CHECK_LANES)
        B = self.traffic.B
        pin = self.cuda
        self.st_host = torch.empty(B, dtype=torch.int32, pin_memory=pin)
        self.rv_host = torch.empty((B, self.V), dtype=torch.int32,
                                   pin_memory=pin)
        self.i = 0
        self.prof_inputs = []
        if self.trace:
            self.warm_profiler()
            self.prof_inputs = [self._input_buffers() for _ in
                                range(PROFILE_BATCHES)]
        for _ in range(WARMUP_BATCHES):
            self.step(*self.traffic.batch(self.i))
        self.sync()
        self.rec["setup_peak_bytes"] = (torch.cuda.max_memory_allocated(
            self.device) if self.cuda else 0)
        self.rec["setup_s"] = time.perf_counter() - self.t_start

    def _load(self):
        """Every key once, with its loaded value, through the facade's
        upserts in batches of the configuration's `load_batch`."""
        order = gen.load_order(self.seed, self.n_keys, self.device)
        nb = int(self.conf["load_batch"])
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        for lo in range(0, self.n_keys, nb):
            keys = order[lo:lo + nb]
            ops = torch.full_like(keys, gen.OP_UPSERT)
            st, _ = self.store.apply(keys, ops,
                                     gen.loaded_values(self.seed, keys, self.V))
            bad += (st != gen.ST_OK).sum()
        self.rec["load_wrong"] = int(bad)

    # -- the closed loop --------------------------------------------------------
    def step(self, keys, ops, vals, span=None) -> float:
        """One batch: submit, wait for its results on the host, keep them
        for the check.  Returns its latency in seconds."""
        self.sync()
        t0 = time.perf_counter()
        if span is None:
            st, rv = self.store.apply(keys, ops, vals)
        else:
            with torch.profiler.record_function(span):
                st, rv = self.store.apply(keys, ops, vals)
        self.st_host.copy_(st, non_blocking=True)
        self.rv_host.copy_(rv, non_blocking=True)
        self.sync()
        t1 = time.perf_counter()
        del st, rv
        self.checker.keep(self.i, self.st_host.numpy(), self.rv_host.numpy())
        self.i += 1
        return t1 - t0

    def window(self):
        rec = self.rec
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            from repro_torch import obs
            obs.configure(enabled=True, reset=True)
            self._count()
        first = self.i
        lat, digests, prof_batches = [], [], []
        marks = [f * self.seconds for f in PROFILE_AT] if self.trace else []
        t0 = time.perf_counter()
        t1 = t0
        while t1 - t0 < self.seconds:
            if marks and t1 - t0 >= marks[0]:
                marks.pop(0)
                d, lats, counts = self._profiled(PROFILE_BATCHES)
                digests.append(d)
                prof_batches.append(counts)
                lat.extend(lats)
            else:
                lat.append(self.step(*self._batch()))
            if self.trace:
                self._count()
            t1 = time.perf_counter()
        rec["window_s"] = t1 - t0
        rec["window_batches"] = self.i - first
        rec["first_window_batch"] = first
        rec["ops"] = (self.i - first) * self.traffic.B
        rec["latencies_s"] = lat
        if self.cuda:
            self.sync()
            rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        else:
            rec["window_peak_bytes"] = 0
        rec["harness_device_bytes"] = self._harness_bytes()
        if self.trace:
            from repro_torch import obs
            spans = obs.trace.TRACER.snapshot()["traceEvents"]
            obs.configure(enabled=False)
            rec["profiler_overhead_s"] = sum(d["overhead_s"] for d in digests)
            rec["compact_s"] = sum(e["dur"] for e in spans
                                   if e.get("ph") == "X"
                                   and e["name"].startswith("compact.")) / 1e6
            obs.configure(enabled=False, reset=True)
            rec["prof"] = profiling.merge(digests)
            rec["prof_work"] = {k: sum(c[k] for c in prof_batches)
                                for k in ("ops", "read", "found", "write")}
            rec["window_counters"] = self.counted

    def _batch(self):
        return self.traffic.batch(self.i)

    def _harness_bytes(self) -> int:
        """What the harness holds on the device while the store runs: the
        generator's table and one batch's inputs."""
        B, V = self.traffic.B, self.V
        inputs = B * 4 * 2 + (B * V * 4 if self.traffic.writes else 0)
        return self.traffic.device_bytes() + inputs

    def _profiled(self, n: int):
        """n batches under the profiler, their inputs made first (so the
        only kernels in the trace are the store's), each facade call inside
        the `APPLY_SPAN` record function.  Returns the digest (with
        `overhead_s`: the sub-window's wall time outside its batches), the
        latencies and the batches' read, found and write lanes."""
        from torch.profiler import profile
        t0 = time.perf_counter()
        batches = []
        for j, bufs in enumerate(self.prof_inputs[:n]):
            made = self.traffic.batch(self.i + j)
            for buf, x in zip(bufs, made):
                if buf is not None:
                    buf.copy_(x)
            batches.append(bufs)
            del made
        counts = dict(ops=len(batches) * self.traffic.B, read=0, found=0,
                      write=0)
        for keys, ops, _ in batches:
            counts["read"] += int((ops == gen.OP_READ).sum())
            counts["write"] += int(((ops == gen.OP_UPSERT)
                                    | (ops == gen.OP_RMW)).sum())
        lats = []
        with profile(activities=self._activities()) as prof:
            for keys, ops, vals in batches:
                i = self.i
                lats.append(self.step(keys, ops, vals,
                                      span=profiling.APPLY_SPAN))
                st = self.checker.status[i]
                read = (ops == gen.OP_READ).cpu().numpy()
                counts["found"] += int(((st == gen.ST_OK) & read).sum())
        d = profiling.digest(prof, n)
        d["overhead_s"] = time.perf_counter() - t0 - sum(lats)
        return d, lats, counts

    def _count(self):
        """Add the program's own counters' (the facade's) growth since the
        last call to `counted`, modulo COUNTER_WRAP; traced runs call it at
        the window's start and after each batch or sub-window, outside the
        batches' timing.  A store put in the program's place has none."""
        if self.store_factory is not None:
            self.counted = None
            return
        now = self.facade.counters(self.store)
        if self._last_count is None:
            self.counted = dict.fromkeys(now, 0)
        else:
            for k, v in now.items():
                self.counted[k] += (v - self._last_count[k]) % COUNTER_WRAP
        self._last_count = now

    def _input_buffers(self):
        """Device buffers for one traced batch's inputs, made in set-up so
        that the window's allocations do not change when a sub-window
        holds its batches' inputs at once."""
        keys, ops, vals = self.traffic.batch(0)
        return (torch.empty_like(keys), torch.empty_like(ops),
                None if vals is None else torch.empty_like(vals))

    def _activities(self):
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])

    def warm_profiler(self):
        """Start and stop the profiler once in set-up, so its first start
        (the tracing library's initialisation) stays out of the window."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            self.sync()

    # -- after the window -------------------------------------------------------
    def finish(self) -> dict:
        """Free the store, replay every batch through the reference, and
        return the record."""
        rec = self.rec
        rec["memory_peak_bytes"] = max(rec.get("setup_peak_bytes", 0),
                                       rec["window_peak_bytes"])
        self.store = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = DenseStore(self.n_keys, self.V, self.seed, self.device)
        rec["check"] = self.checker.judge(ref, rec["first_window_batch"])
        rec["check"]["load_wrong"] = rec.get("load_wrong", 0)
        rec["check_s"] = time.perf_counter() - t0
        return rec


def limits(check: dict) -> dict:
    """Each compared number beside its limit (exact: 0), and what was
    compared."""
    return {
        "wrong_status": {"value": check["wrong_status"], "limit": 0},
        "wrong_value": {"value": check["wrong_value"], "limit": 0},
        "load_wrong": {"value": check["load_wrong"], "limit": 0},
        "statuses_checked": {"value": check["statuses_checked"],
                             "limit": "> 0"},
        "values_checked": {"value": check["values_checked"], "limit": "> 0"},
    }


def is_correct(check: dict) -> bool:
    return (check["wrong_status"] == 0 and check["wrong_value"] == 0
            and check["load_wrong"] == 0 and check["statuses_checked"] > 0
            and check["values_checked"] > 0)


def result(bench, cell: dict, rec: dict, trace: bool, device: dict) -> dict:
    """The contract's result line: the cell's end-to-end metrics (or, with
    `trace`, its per-layer metrics), each read by its reader module."""
    metrics = {}
    for m in bench.metrics_of(cell["name"], per_layer=trace):
        value = bench.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = rec["check"]
    out = {"correct": is_correct(check), "attempted": rec["ops"],
           "failed": check["window_wrong"], "metrics": metrics,
           "device": device}
    if trace and "prof" in rec:
        out["breakdown"] = {
            "device_ops": profiling.top(rec["prof"]["kernel_s"]),
            "idle_gaps": profiling.top(rec["prof"]["gaps"])}
    out["check"] = limits(check)
    return out


def device_info(rec: dict, chips: int, trace: bool) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace and "prof" in rec:
        d["busy_s"] = rec["prof"]["busy_s"]
        d["window_s"] = rec["prof"]["span_s"]
    return d

