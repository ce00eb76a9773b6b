"""train.step_device_ms: The summed device time of the kernels of a graphed train step, over
the traced steps."""

def read(rec):
    if rec.get("trace") is None or not rec.get("slice_steps"):
        return None
    return 1e3 * sum(rec["trace"]["kernel_s"].values()) / rec["slice_steps"]
