"""startup_share.detect: Seconds in Predictor.load_model over the unprofiled stretch's
wall, in %."""

from harness.readers import part


def read(rec):
    rec = part(rec, "unprofiled")
    if rec.get("load_model_s") is None:
        return None
    return 100 * rec["load_model_s"] / rec["wall_s"]
