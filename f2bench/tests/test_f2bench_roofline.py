"""The roofline's byte counts come from the batch's shape and results."""
import pytest

from f2bench import roofline


def test_probe_bytes():
    # a read: key 4 + op 4 in, status 4 + 25 words out, one index sector;
    # a present key adds its header sector and value row
    assert roofline.probe_bytes(1, 0, 25) == 4 + 4 + 4 + 100 + 32
    assert roofline.probe_bytes(1, 1, 25) == 144 + 32 + 100
    assert roofline.probe_bytes(1000, 600, 25) == 1000 * 144 + 600 * 132


def test_write_bytes():
    # key, op, value in; status out; index sector; header sector and row
    assert roofline.write_bytes(1, 25) == 4 + 4 + 100 + 4 + 32 + 32 + 100
    assert roofline.write_bytes(10, 1) == 10 * (4 + 4 + 4 + 4 + 32 + 32 + 4)


def test_roofline_share():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB in 2 ms at 3.35 TB/s: least time 1 ms, half the roofline
    assert roofline.roofline_pct(3_350_000_000, 2e-3, kind) == pytest.approx(50.0)
    assert roofline.roofline_pct(0, 1.0, kind) is None
    assert roofline.roofline_pct(10, 0.0, kind) is None
