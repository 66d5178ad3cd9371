"""The write-plan kernels' (`fused_write.cu`, five kernels summed) share of
their roofline over the traced sub-windows: the least time the batches'
writes need at the card's memory bandwidth (`roofline.write_bytes`) over
the kernels' device time, in %."""
from f2bench import profiling, roofline


def read(rec):
    p = rec.get("prof")
    if not p or not rec.get("device_kind"):
        return None
    return roofline.roofline_pct(
        roofline.write_bytes(rec["prof_work"]["write"], rec["value_width"]),
        profiling.kernel_seconds(p, "fused_write"), rec["device_kind"])
