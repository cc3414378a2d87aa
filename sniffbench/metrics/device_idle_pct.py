"""100 - the union of device activity over the traced window's wall time."""


def read(rec):
    if not rec.get("window_s") or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
