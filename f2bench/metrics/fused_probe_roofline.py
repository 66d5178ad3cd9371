"""The probe kernels' share of their roofline over the traced sub-windows:
the least time the batches' reads need at the card's memory bandwidth
(`roofline.probe_bytes`) over the kernels' device time, in %.  Probes that
compaction runs add time and no bytes, so a sub-window with a compaction
pass reads low, never high."""
from f2bench import profiling, roofline


def read(rec):
    p = rec.get("prof")
    if not p or not rec.get("device_kind"):
        return None
    w = rec["prof_work"]
    return roofline.roofline_pct(
        roofline.probe_bytes(w["read"], w["found"], rec["value_width"]),
        profiling.kernel_seconds(p, "fused_probe"), rec["device_kind"])
