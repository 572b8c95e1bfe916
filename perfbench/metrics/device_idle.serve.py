"""device_idle.serve: the share of the serving batches traced after the
window in which no operation ran on the device, in percent."""


def read(rec):
    t = rec.trace
    if rec.kind != "serve" or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
