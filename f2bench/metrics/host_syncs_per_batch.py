"""Host waits for the device (CUDA runtime synchronize calls) inside the
facade's calls, per batch, over the traced sub-windows."""


def read(rec):
    p = rec.get("prof")
    if not p or not p["batches"] or not p["runtime_events"]:
        return None
    return p["syncs"] / p["batches"]
