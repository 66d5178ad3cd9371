"""The port's core types against the JAX package's: the slot hash, the
config mapping, the flush accounting, and the options this slice refuses."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.kernels.f2_probe import ref as tref  # noqa: E402

EDGE_KEYS = np.array([0, 1, -1, 2**31 - 1, -2**31, 0x7FEB352D, 12345,
                      0x846CA68B - 2**32, 2**30, 2**30 - 1, -2**30],
                     dtype=np.int32)


def _random_keys():
    rng = np.random.default_rng(0)
    return rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("keys", [EDGE_KEYS, _random_keys()],
                         ids=["edge", "random"])
def test_hash32_bit_exact(keys):
    want = np.asarray(jtypes.hash32(jnp.asarray(keys))).astype(np.int64)
    got = ttypes.hash32(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # the kernel package's standalone copy of the hash agrees too
    assert np.array_equal(tref._mix(torch.from_numpy(keys)).numpy(), want)


@pytest.mark.parametrize("size", [1 << 9, 1 << 22, 1 << 30])
def test_slot_of_keys_matches_reference_slots(size):
    keys = np.concatenate([EDGE_KEYS, _random_keys()])
    want = np.asarray((jtypes.hash32(jnp.asarray(keys)) & jnp.uint32(size - 1))
                      .astype(jnp.int32))
    got = ttypes.slot_of_keys(torch.from_numpy(keys), size)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("engine", ["unfused", "fused", "fused_ref", "fused_cuda"])
def test_config_round_trip_through_reference(engine):
    tcfg = T.F2Config(value_width=25, chain_max=48, engine=engine,
                      rc_capacity=1 << 9, hot_mutable_frac=0.75)
    jcfg = J.F2Config(**interop.config_to_dict(tcfg))
    assert jcfg.engine == interop.ENGINE_TO_REFERENCE[engine]
    back = interop.config_from_dict(dataclasses.asdict(jcfg))
    assert back == tcfg
    assert (back.record_bytes, back.chunk_bytes, back.cold_index_slots) == \
        (jcfg.record_bytes, jcfg.chunk_bytes, jcfg.cold_index_slots)


def test_config_refuses_what_this_slice_does_not_do():
    # the host tier is ported: its config is checked as the reference's is
    assert T.F2Config(host_tier=True).host_tier
    with pytest.raises(ValueError, match="host_chunk_records"):
        T.F2Config(host_tier=True, host_chunk_records=24)
    with pytest.raises(ValueError):
        T.F2Config(engine="jnp")            # the reference's name, not the port's
    with pytest.raises(ValueError):
        T.F2Config(hot_capacity=3000)


def test_records_to_blocks_and_constants():
    n = np.array([0, 1, 35, 36, 4096, 123457, 2**24], np.int32)
    for rb in (24, 116, 256):
        want = np.asarray(jtypes.records_to_blocks(jnp.asarray(n), rb))
        got = ttypes.records_to_blocks(torch.from_numpy(n), rb)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for name in ("NULL_ADDR", "RC_FLAG", "META_TOMBSTONE", "META_INVALID"):
        assert int(getattr(jtypes, name)) == getattr(ttypes, name), name
    for name in ("OP_NOOP", "OP_READ", "OP_UPSERT", "OP_RMW", "OP_DELETE",
                 "ST_NONE", "ST_OK", "ST_NOT_FOUND", "ST_CREATED", "BLOCK_BYTES"):
        assert getattr(J, name) == getattr(T, name), name
