"""Kernels the device ran per batch (copies and memsets left out) over the
traced sub-windows; the harness makes those batches' inputs before the
profiler starts, so every kernel is the store's."""


def read(rec):
    p = rec.get("prof")
    if not p or not p["batches"] or not p["launches"]:
        return None
    return p["launches"] / p["batches"]
