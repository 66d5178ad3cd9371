"""A durable directory crosses between the packages: each package's
`recover` restores a snapshot (and replays the WAL suffix) that the other
wrote.  The port writes its store snapshots under the reference's leaf
names and in its order (`interop.snapshot_tree`); the reference's restore
matches leaves by position only, so every check here is by name: each leaf
of the snapshot file against the restored store's leaf of that name, bit
for bit, then the two packages' recoveries of one directory against each
other, leaf by leaf and by their reads.  A count check would not see two
leaves that swapped places."""
import json
import os
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.core import durability as jdur  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import durability as tdur  # noqa: E402
from test_durability import N_KEYS, gen_batches  # noqa: E402
from torch_durability_oracle import assert_stores_equal, port_store, ref_store  # noqa: E402
from torch_parity import as_np, small_dict  # noqa: E402


def _file_leaves(d) -> dict:
    """{leaf name: array} of the newest snapshot under durable dir `d`,
    read from its manifest and leaves file."""
    snap = os.path.join(d, "snap")
    step = max(int(x[5:]) for x in os.listdir(snap) if x.startswith("step_"))
    base = os.path.join(snap, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        man = json.load(f)
    out = {}
    with open(os.path.join(base, "leaves.bin"), "rb") as f:
        for name, off in zip(man["leaves"], man["offsets"]):
            f.seek(off)
            out[name] = np.lib.format.read_array(f, allow_pickle=False)
    assert len(out) == len(man["leaves"]), "a leaf name written twice"
    return out


def _history(dkv, seed, at_snapshot=lambda: None):
    """Batches, a blocking snapshot, more batches (the WAL suffix); the
    wrapper is then abandoned (a kill at a batch boundary).  Returns what
    `at_snapshot()` gave just before the snapshot."""
    batches = gen_batches(seed, 6)
    for ks, ops, vs in batches[:3]:
        dkv.apply(ks, ops, vs)
    seen = at_snapshot()
    dkv.snapshot(blocking=True)
    for ks, ops, vs in batches[3:]:
        dkv.apply(ks, ops, vs)
    return seen


def _port_named(state, R) -> dict:
    """{reference name: array} of a port store's state leaves, through
    `state_to_numpy` (the parity tests' path, not the snapshot's)."""
    return {f"['state'].{n}": a for n, a in
            zip(interop.leaf_names(), interop.state_to_numpy(state, n_replicas=R))}


def _recover_both(d, replicated, tmp):
    """Both packages' recoveries of copies of durable dir `d`."""
    dj, dt = str(tmp / "rj"), str(tmp / "rt")
    shutil.copytree(d, dj)
    shutil.copytree(d, dt)
    jrec = jdur.recover(dj, lambda: ref_store(replicated=replicated))
    trec = tdur.recover(dt, lambda: port_store(replicated=replicated))
    return jrec, trec


def _same_recoveries(jrec, trec, ctx):
    assert_stores_equal(jrec.kv, trec.kv, ctx)
    keys = np.arange(N_KEYS, dtype=np.int32)
    for off in range(0, N_KEYS, 100):
        a, b = jrec.read(keys[off:off + 100]), trec.read(keys[off:off + 100])
        np.testing.assert_array_equal(np.asarray(a[0]), as_np(b[0]), ctx)
        np.testing.assert_array_equal(np.asarray(a[1]), as_np(b[1]), ctx)
    trec.close()


@pytest.mark.parametrize("replicated", [False, True], ids=["sharded", "replicated"])
def test_port_recovers_the_references_directory(tmp_path, replicated):
    d = str(tmp_path / "d")
    jdkv = jdur.DurableKV(ref_store(replicated=replicated),
                          jdur.DurabilityConfig(dir=d))
    _history(jdkv, 21)
    jdkv.ckpt.wait()
    R = 2 if replicated else None
    # the reference's snapshot, restored by the port into a fresh store:
    # every leaf of the file equals the port's leaf of that name
    fresh = port_store(replicated=replicated)
    meta = tdur._meta_like(fresh)
    tree = interop.snapshot_tree(fresh.state, meta, R)
    ck = Checkpointer(os.path.join(d, "snap"))
    ck.restore(tree, step=ck.latest_step())
    want = _file_leaves(d)
    assert list(want) == list(tree)             # the names, in the order
    got = _port_named(fresh.state, R)
    got.update({interop.snapshot_meta_name(k): v.numpy() for k, v in meta.items()})
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        b = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
        assert np.array_equal(a, b), name
    # the whole recovery (snapshot + WAL suffix) in both packages
    jrec, trec = _recover_both(d, replicated, tmp_path)
    assert trec.recovery["snapshot_epoch"] == 1 and trec.recovery["records"] > 0
    _same_recoveries(jrec, trec, "reference-written")


@pytest.mark.parametrize("replicated", [False, True], ids=["sharded", "replicated"])
def test_reference_recovers_the_ports_directory(tmp_path, replicated):
    d = str(tmp_path / "d")
    tdkv = T.DurableKV(port_store(replicated=replicated), T.DurabilityConfig(dir=d))
    R = 2 if replicated else None
    live = _history(tdkv, 23, lambda: _port_named(tdkv.kv.state, R))
    tdkv.wait()
    want = _file_leaves(d)
    # the port wrote the reference's names, in its flattening order
    jkv = ref_store(replicated=replicated)
    meta_like = {"bucket_map": jkv.bucket_map.copy(), "map_version": np.int64(0),
                 "epoch": np.int64(0), "seq": np.int64(0)}
    if replicated:
        meta_like["alive"] = jkv.alive.copy()
    like = {"state": jkv.state, "meta": meta_like}
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(like)]
    assert list(want) == names
    # each leaf as the reference writes its own (`np.asarray` of the leaf)
    for path, leaf in jax.tree_util.tree_leaves_with_path(like):
        a, b = want[jax.tree_util.keystr(path)], np.asarray(leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, path
    # the reference's restore places leaves by position: each restored leaf
    # equals the file's leaf of its own name (as JAX's 32-bit default casts
    # the int64 metadata)
    payload, _ = JCheckpointer(os.path.join(d, "snap")).restore(like)
    for path, leaf in jax.tree_util.tree_leaves_with_path(payload):
        a, b = want[jax.tree_util.keystr(path)], np.asarray(leaf)
        assert a.shape == b.shape and np.array_equal(a, b), path
    # and the file holds the port's live state at the snapshot, by name
    for name, a in live.items():
        b = want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    jrec, trec = _recover_both(d, replicated, tmp_path)
    _same_recoveries(jrec, trec, "port-written")


def test_snapshot_names_follow_the_reference_flattening():
    """`snapshot_leaf_names` against JAX's own flattening of a reference
    snapshot payload, spilled-store metadata included."""
    import repro.core as J
    from repro.core import store as jstore
    meta = {k: np.zeros(1, np.int32) for k in
            ("seq", "epoch", "bucket_map", "map_version", "alive", "host_key",
             "host_val", "host_prev", "host_meta", "host_ids", "host_shard")}
    state = jstore.create(J.F2Config(**small_dict()))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path({"state": state, "meta": meta})]
    assert interop.snapshot_leaf_names(meta) == names
