"""A traced run (`--trace 1`) reads its per-layer metrics: here on the CPU
at a tiny size, with the program's int32 read counter made to wrap inside
the window."""
import tiny
from f2bench import harness, manifest

SEED = 2 ** 31 + 77


class WrappingCounter:
    """The store, its `io_stats()["read_ops"]` shifted so that its first
    reading is the int32 maximum and the next ones wrap to negative
    numbers; the true and the reported values are kept."""

    def __init__(self, store):
        self.store, self.seen, self.reported = store, [], []
        self.shift = None

    def __getattr__(self, name):
        return getattr(self.store, name)

    def io_stats(self):
        io = dict(self.store.io_stats())
        self.seen.append(io["read_ops"])
        if self.shift is None:
            self.shift = 2 ** 31 - 1 - io["read_ops"]
        shifted = io["read_ops"] + self.shift
        io["read_ops"] = (shifted + 2 ** 31) % 2 ** 32 - 2 ** 31
        self.reported.append(io["read_ops"])
        return io


def test_traced_run_reads_stable_reads_across_a_wrap(tmp_path):
    root = tiny.make_root(tmp_path, cells=("kv_a_zipf",))
    stores = []

    def wrap(store):
        stores.append(WrappingCounter(store))
        return stores[0]

    run = harness.Run(root, "kv_a_zipf", SEED, 1.5, True, device="cpu",
                      wrap=wrap)
    run.setup()
    run.window()
    rec = run.finish()
    out = harness.result(manifest.load(root), run.cell, rec, True,
                         {"platform": "cpu"})
    assert out["correct"]
    seen = stores[0].seen       # the window's start, then after each batch
    assert len(seen) >= 2
    true = seen[-1] - seen[0]
    assert true > 0
    assert stores[0].reported[-1] < stores[0].reported[0]   # it wrapped
    ops = rec["ops"]
    assert out["metrics"]["stable_reads_per_op"]["value"] == true / ops
