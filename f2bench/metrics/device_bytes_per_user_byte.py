"""Peak device bytes the program held in the window (the allocator's peak
after a reset at the window's start, less what the harness itself holds
there) over the bytes loaded: n_keys x (8-byte key + the value row)."""


def read(rec):
    peak = rec.get("window_peak_bytes", 0)
    if not peak:
        return None
    user = rec["n_keys"] * (8 + 4 * rec["value_width"])
    return (peak - rec["harness_device_bytes"]) / user
