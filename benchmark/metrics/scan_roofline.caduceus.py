"""scan_roofline.caduceus: The scan's bound (harness/work_caduceus.py scan_bound_seconds) for
the bases of the profiled stretch over the summed device time of the kernels between the
in- and the out-projection (cad_conv_kernel and cad_scan_kernel) there, in %."""

from harness import work_caduceus
from harness.readers import part
from harness.trace import kernel_seconds

KERNELS = ("cad_conv_kernel", "cad_scan_kernel")


def read(rec):
    rec = part(rec, "profiled")
    summary = rec.get("trace")
    if summary is None or not rec.get("bases"):
        return None
    seconds = sum(kernel_seconds(summary, k) for k in KERNELS)
    if seconds <= 0:
        return None
    return 100 * work_caduceus.scan_bound_seconds(rec["bases"]) / seconds
