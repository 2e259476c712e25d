"""step_mfu: the whole substep's share of the card's roofline: the least
time its counted work needs (portbench/roofline.py::substep_bound) over
the window's time a substep (percent)."""

from portbench import roofline


def read(record):
    if not record.get("on_card"):
        return None
    if not record["substeps"]:
        return None
    nl, nyp, nxp, nyt, nxt = record["grid"]
    bound_ms, _ = roofline.substep_bound(nl, nyp, nxp, nyt, nxt,
                                         record["dtype"], record["members"])
    return 100.0 * bound_ms / (record["window_s"] * 1e3 / record["substeps"])
