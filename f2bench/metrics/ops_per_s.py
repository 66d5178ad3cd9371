"""Ops completed in the timed window over its wall time (host clock)."""


def read(rec):
    return rec["ops"] / rec["window_s"] if rec.get("window_s") else None
