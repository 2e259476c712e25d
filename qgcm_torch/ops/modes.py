"""The inversions' products between layers and vertical modes: a (K, M)
matrix applied along the leading axis of a (M, ny, nx) field. The ocean's
PV inversion (models/ocean.py::_ocinvq) turns its layers' PV into modes
through it, and the box's modal pressures back into layers; a channel's
pressure assembly (models/ocean.py::_channel_pressure, which the
atmosphere's inversion shares) turns its modes back into layers.

`modes(mat, x)` is torch.einsum("km,myx->kyx", mat, x), the same call in
every dtype and under torch.func.vmap (a call under vmap is one call for
all members), each call adding one to `modes.launches`. Profiles name it
`qgcm_torch::modes`.
"""

from __future__ import annotations

import contextlib

import torch


def modes(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_m mat[k, m] x[m, y, x] for every k: (K, ny, nx)."""
    modes.launches += 1
    with (torch.profiler.record_function("qgcm_torch::modes")
          if torch.autograd._profiler_enabled() else contextlib.nullcontext()):
        return torch.einsum("km,myx->kyx", mat, x)


def reset_launches():
    """Set the products' call count to zero."""
    modes.launches = 0


reset_launches()
