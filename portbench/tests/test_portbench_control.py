"""The control, at a size the CPU holds: the reference computed in
float32 with its layer/mode products in TF32 (the precision below the
configuration's float32 with TF32 off), put in the program's place,
fails the cell's limits; the program's float32 run meets them."""

import pytest
import torch

from conftest import small_numbers, with_members
from portbench import checks, traffic
from portbench.calibrate import control_states
from portbench.cell import load_cell, reference_gaps

SEED = 3 * 2**31 + 5


@pytest.mark.parametrize("name,members", [("natl_1km.single", 1),
                                          ("natl_1km.single", 3)])
def test_control_reads_not_correct(name, members):
    cell = load_cell(name)
    if members > 1:
        with_members(cell, members)
    m = small_numbers(cell)
    t = cell.traffic
    inputs = traffic.make_inputs(m, t, SEED, "cpu", torch.float32)
    got = control_states(cell.config, m, t, inputs, 4 * t["chunk"],
                         torch.device("cpu"))
    gaps = reference_gaps(cell.config, m, inputs, t["chunk"], *got,
                          torch.device("cpu"))
    readings = dict(zip(("start", "final"),
                        (float(g.max()) for g in gaps)))
    limits = {k: v for k, v in cell.limits.items() if k in readings}
    _, ok = checks.judge(readings, limits)
    assert not ok
    assert sum(readings[k] > limits[k] for k in readings) >= 1
