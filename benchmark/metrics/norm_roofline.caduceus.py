"""norm_roofline.caduceus: The add-norms' bound (harness/work_caduceus.py
norm_bound_seconds: their bytes at HBM's bandwidth) for the bases of the profiled
stretch over the summed device time of cad_add_norm_kernel there, in %."""

from harness import work_caduceus
from harness.readers import part
from harness.trace import kernel_seconds


def read(rec):
    rec = part(rec, "profiled")
    summary = rec.get("trace")
    if summary is None or not rec.get("bases"):
        return None
    seconds = kernel_seconds(summary, "cad_add_norm_kernel")
    if seconds <= 0:
        return None
    return 100 * work_caduceus.norm_bound_seconds(rec["bases"]) / seconds
