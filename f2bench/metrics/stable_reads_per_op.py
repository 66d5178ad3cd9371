"""The store's modeled stable-tier reads (`io_stats()["read_ops"]`) per
op over the window of a traced run (the counter's growth summed batch by
batch modulo 2^32: the program's counter is int32)."""


def read(rec):
    c = rec.get("window_counters")
    if not c or not rec.get("ops"):
        return None
    return c["read_ops"] / rec["ops"]
