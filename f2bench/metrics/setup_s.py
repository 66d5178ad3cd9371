"""From process start to the first timed batch: kernel build or load, the
store, the load of every key, the harness's tables, the warm-up."""


def read(rec):
    return rec.get("setup_s")
