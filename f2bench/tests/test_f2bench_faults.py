"""The check fails a broken timed path.  Each test drives the rest of a run
(set-up, the closed loop, the reference's replay) on the CPU at a tiny
size, skipping only the look for a card, with the store broken underneath:
its writes dropped (a step that returns its state unchanged), half of each
batch never answered, one answer altered where it is produced, and the
control (the reference in the program's place, values narrowed to int16).
A sound run of the same cells comes out correct."""
import pytest
import torch

import tiny
from f2bench import gen, harness
from f2bench.reference import DenseStore

SEED = 2 ** 31 + 4242


class Wrapped:
    def __init__(self, store):
        self.store = store

    def __getattr__(self, name):
        return getattr(self.store, name)


class DropWrites(Wrapped):
    """Writes acknowledged OK but never applied."""

    def apply(self, keys, ops, vals=None):
        w = (ops == gen.OP_UPSERT) | (ops == gen.OP_RMW)
        st, rv = self.store.apply(keys, torch.where(w, gen.OP_NOOP, ops)
                                  .to(torch.int32), vals)
        return torch.where(w, gen.ST_OK, st).to(torch.int32), rv


class HalfBatch(Wrapped):
    """Only the first half of each batch is run; the rest is left out."""

    def apply(self, keys, ops, vals=None):
        h = keys.shape[0] // 2
        st, rv = self.store.apply(keys[:h], ops[:h],
                                  None if vals is None else vals[:h])
        st_all = torch.zeros_like(keys)
        rv_all = torch.zeros((keys.shape[0], rv.shape[1]), dtype=rv.dtype)
        st_all[:h], rv_all[:h] = st, rv
        return st_all, rv_all


class AlterOne(Wrapped):
    """One read lane of each batch answers a value off by one."""

    def apply(self, keys, ops, vals=None):
        st, rv = self.store.apply(keys, ops, vals)
        reads = (ops == gen.OP_READ).nonzero().flatten()
        if reads.numel():
            lane = reads[torch.randint(reads.numel(), (1,))]
            rv = rv.clone()
            rv[lane, 0] += 1
        return st, rv


def run(root, cell, **kw):
    r = harness.Run(root, cell, SEED, 1.5, False, device="cpu", **kw)
    r.setup()
    r.window()
    return r.finish()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["kv_a_zipf", "kv_c_uniform"])
def test_sound_run_is_correct(root, cell):
    rec = run(root, cell)
    assert harness.is_correct(rec["check"]), rec["check"]
    assert rec["check"]["values_checked"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("kv_a_zipf", DropWrites), ("kv_a_zipf", HalfBatch),
    ("kv_c_uniform", HalfBatch), ("kv_a_zipf", AlterOne),
    ("kv_c_uniform", AlterOne)])
def test_fault_is_not_correct(root, cell, fault):
    rec = run(root, cell, wrap=fault)
    assert not harness.is_correct(rec["check"]), rec["check"]


@pytest.mark.parametrize("cell", ["kv_a_zipf", "kv_c_uniform"])
def test_control_is_not_correct(root, cell):
    def narrow(r):
        return DenseStore(r.n_keys, r.V, r.seed, r.device, narrow=True)
    rec = run(root, cell, store_factory=narrow)
    assert rec["check"]["wrong_value"] > 0
    assert not harness.is_correct(rec["check"])
