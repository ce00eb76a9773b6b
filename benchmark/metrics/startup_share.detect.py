"""startup_share.detect: Seconds in Predictor.load_model over the window's wall, in %."""

def read(rec):
    if rec.get("load_model_s") is None:
        return None
    return 100 * rec["load_model_s"] / rec["wall_s"]
