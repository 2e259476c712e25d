"""Settings of the benchmark's own tests (python -m pytest portbench/tests).

Tests that need a CUDA card take the `card` fixture, which skips them
where there is none; whether there is one is decided there, when the
test runs, never while a module is imported."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


# a members mix's perturbation: `qgcm ensemble`'s default --amp, smoothed
PERTURBATION = {"amp": 1.0e-3, "n_smooth": 4}


def with_members(cell, members, limits=None):
    """`cell` stepping `members` trajectories of its mix, members 1..
    perturbed, held to `limits` where given."""
    cell.traffic = dict(cell.traffic, members=members,
                        perturbation=PERTURBATION)
    if limits is not None:
        cell.limits = limits
    return cell


def small_numbers(cell, **grid):
    """The cell's configuration numbers on a small box for the CPU: a
    48 x 48 T-grid under a 12 x 12 atmosphere unless `grid` says."""
    m = copy.deepcopy(cell.config["model"])
    m.update(dict(nxta=12, nyta=12, nxaooc=6, nyaooc=6, ndxr=8), **grid)
    return m
