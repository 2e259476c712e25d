"""The one generator of the inputs: the same seed gives the same
inputs, every seed the same sizes; the members' perturbations have the
mix's RMS and vanish on the solid walls; a cyclic ocean keeps its
duplicate east column."""

import pytest
import torch

from conftest import small_numbers, with_members
from portbench import traffic
from portbench.cell import load_cell

SEEDS = (1, 2**31 + 3, 3 * 2**33 + 11)


def _inputs(m, t, seed):
    return traffic.make_inputs(m, t, seed, "cpu", torch.float64)


@pytest.mark.parametrize("cyclic", [False, True])
def test_inputs_from_the_seed(cyclic):
    cell = with_members(load_cell("natl_1km.single"), 3)
    m = small_numbers(cell, cyclic_ocean=cyclic)
    t = cell.traffic
    a, b = _inputs(m, t, SEEDS[1]), _inputs(m, t, SEEDS[1])
    for k in a:
        assert torch.equal(a[k], b[k])
    c = _inputs(m, t, SEEDS[2])
    assert {k: v.shape for k, v in a.items()} == {k: v.shape
                                                  for k, v in c.items()}
    assert not torch.equal(a["po"], c["po"])
    noise = a["po"][1:] - a["po"][:1]
    assert torch.equal(noise[..., 0, :], torch.zeros_like(noise[..., 0, :]))
    assert torch.equal(noise[..., -1, :], torch.zeros_like(noise[..., -1, :]))
    if cyclic:
        assert torch.equal(a["po"][..., -1], a["po"][..., 0])
    else:
        assert torch.equal(noise[..., 0], torch.zeros_like(noise[..., 0]))
    # the smooth noise has unit RMS before the window takes its share
    rms = noise.square().mean((-3, -2, -1)).sqrt()
    assert torch.all(rms < t["perturbation"]["amp"])
    assert torch.all(rms > 0.2 * t["perturbation"]["amp"])


def test_eddy_centre_moves_within_its_shift():
    cell = load_cell("natl_1km.single")
    m = cell.config["model"]
    nxt = m["ndxr"] * m["nxaooc"]
    centres = {traffic.eddy_centre(m, cell.traffic, s) for s in SEEDS}
    assert len(centres) == len(SEEDS)
    for i, j in centres:
        assert abs(i - nxt // 2) <= cell.traffic["eddy"]["shift"] * nxt + 1
