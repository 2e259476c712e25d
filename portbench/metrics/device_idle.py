"""device_idle: the share of the window in which the device ran nothing
(percent): one less the device's busy seconds a substep in the traced
stretch (the union of its kernels, copies and sets) over the window's
seconds a substep. The window is the untraced one, so the profiler's
own host cost is not counted as idle; the traced stretch's own busy and
host seconds are the result's device.busy_s and device.window_s."""


def read(record):
    if not record.get("on_card"):
        return None
    tr = record.get("trace")
    if not tr or not tr["activities"] or not record["substeps"]:
        return None
    busy = tr["busy_s"] / tr["substeps"]
    return 100.0 * (1.0 - busy / (record["window_s"] / record["substeps"]))
