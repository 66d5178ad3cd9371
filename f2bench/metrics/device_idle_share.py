"""1 - the device's busy time (the union of its operations' intervals)
over the wall time of the traced sub-windows, in %."""


def read(rec):
    p = rec.get("prof")
    if not p or not p["span_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])
