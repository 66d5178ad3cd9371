"""Wall time inside the store's compaction spans (`compact.*`, the
program's own obs spans) over the window's wall time, in %.  The traced
run's profiler start, stop and reading are left out of the wall time: the
window spends that time in no batch."""


def read(rec):
    if "compact_s" not in rec or not rec.get("window_s"):
        return None
    wall = rec["window_s"] - rec.get("profiler_overhead_s", 0.0)
    return 100.0 * rec["compact_s"] / wall if wall > 0 else None
