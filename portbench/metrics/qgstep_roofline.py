"""qgstep_roofline: the full-field vorticity kernel's share of its
roofline: its bound (portbench/roofline.py::kernel_bound; in member mode
the shared wind plane counted once) over its mean device time a launch
in the traced stretch, found by the kernel's name (percent)."""

from portbench import roofline, trace


def read(record):
    if not record.get("on_card"):
        return None
    tr = record.get("trace")
    if not tr:
        return None
    n, mean_s = trace.kernel_time(tr, "qgstep_kernel")
    if not n:
        return None
    nl, nyp, nxp, _, _ = record["grid"]
    members = record["members"]
    bound_ms, _ = roofline.kernel_bound(
        nl, nyp, nxp, record["dtype"], members=members,
        shared_planes=1 if members > 1 else 0)
    return 100.0 * bound_ms / (mean_s * 1e3)
