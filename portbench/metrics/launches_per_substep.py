"""launches_per_substep: the device activities (kernels, copies, sets)
of the traced stretch, over its substeps."""


def read(record):
    if not record.get("on_card"):
        return None
    tr = record.get("trace")
    if not tr or not tr["activities"]:
        return None
    return tr["activities"] / tr["substeps"]
