"""The yardstick's counts at shapes worked out by hand."""

import math

import pytest

from portbench import roofline


def test_kernel_bound_of_eight_members_counts_the_wind_plane_once():
    # 4 bytes x 961^2 x (8 x (5 x 3 + 2 - 1) + 1) at 3.35 TB/s
    ms, by = roofline.kernel_bound(3, 961, 961, "float32", members=8,
                                   shared_planes=1)
    assert by == "bytes"
    assert ms == pytest.approx(4 * 961**2 * 129 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.1422, abs=5e-5)


def test_kernel_bound_of_one_trajectory():
    ms, by = roofline.kernel_bound(3, 4801, 4801, "float32")
    assert by == "bytes"
    assert ms == pytest.approx(4 * 4801**2 * 17 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.4679, abs=5e-5)


def test_substep_counts_by_hand():
    # nl 2, a 5 x 5 p grid (3 x 3 interior), a 4 x 4 T grid, one member
    nbytes = roofline.substep_bytes(2, 5, 5, 4, 4, "float32")
    assert nbytes == 4 * (6 * 2 * 25 + 3 * 16) + 4 * (3 * 25 + 2 * 16)
    flop = roofline.substep_flop(2, 5, 5)
    dst3 = 2.5 * 3 * math.log2(3)
    assert flop == pytest.approx(2 * 25 * 56 + 7 * 25
                                 + 2 * 2 * (3 * dst3 + 3 * dst3))
    # two members: everything but the shared forcing planes doubles
    assert roofline.substep_bytes(2, 5, 5, 4, 4, "float32", 2) == \
        nbytes + 4 * (6 * 2 * 25 + 3 * 16)
    assert roofline.substep_flop(2, 5, 5, 2) == pytest.approx(2 * flop)


def test_substep_bound_is_set_by_the_bytes_at_the_cells_sizes():
    for nyp, members in ((961, 8), (4801, 1)):
        ms, by = roofline.substep_bound(3, nyp, nyp, nyp - 1, nyp - 1,
                                        "float32", members)
        assert by == "bytes"
        assert ms == pytest.approx(
            roofline.substep_bytes(3, nyp, nyp, nyp - 1, nyp - 1, "float32",
                                   members) / 3.35e12 * 1e3)
