"""Carry state and forcing across between qgcm_tpu and the port.

The JAX package's OceanState / OceanForcing / AtmosState /
AtmosForcing are handed over as a mapping of field name to NumPy array
({k: np.asarray(v) for k, v in st._asdict().items()}); they become
the port's tensors on a given device (the card unless the caller asks
for "cpu") and dtype.
The state converters take qgcm_tpu's stacked ensemble members as they
are (NumPy arrays with a leading member axis, models/ensemble.py), and
`sensitivity_to_torch` its adjoint's OceanSensitivity.
`to_numpy` goes back: a dict of NumPy arrays (in the tensors' dtype)
keyed by field name, from which the JAX NamedTuple is rebuilt with
`Cls(**d)`.
This module imports neither JAX nor qgcm_tpu.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .state import AtmosForcing, AtmosState, OceanForcing, OceanState


def _to_torch(cls, src: Mapping, device, dtype):
    device = resolve_device(device)
    return cls(**{name: torch.tensor(np.asarray(src[name])).to(
        device=device, dtype=dtype) for name in cls._fields})


def state_to_torch(src: Mapping, device="cuda",
                   dtype=torch.float64) -> OceanState:
    """OceanState of tensors from {field: array}."""
    return _to_torch(OceanState, src, device, dtype)


def forcing_to_torch(src: Mapping, device="cuda",
                     dtype=torch.float64) -> OceanForcing:
    """OceanForcing of tensors from {field: array}."""
    return _to_torch(OceanForcing, src, device, dtype)


def atmos_state_to_torch(src: Mapping, device="cuda",
                         dtype=torch.float64) -> AtmosState:
    """AtmosState of tensors from {field: array}."""
    return _to_torch(AtmosState, src, device, dtype)


def atmos_forcing_to_torch(src: Mapping, device="cuda",
                           dtype=torch.float64) -> AtmosForcing:
    """AtmosForcing of tensors from {field: array}."""
    return _to_torch(AtmosForcing, src, device, dtype)


def sensitivity_to_torch(src: Mapping, device="cuda",
                         dtype=torch.float64):
    """adjoint.OceanSensitivity of tensors from {"state0": {field:
    array}, "forcing": (d/dtauxo, d/dtauyo, d/dfnetoc) arrays}."""
    from .adjoint import OceanSensitivity
    device = resolve_device(device)
    return OceanSensitivity(
        state0=state_to_torch(src["state0"], device, dtype),
        forcing=tuple(torch.tensor(np.asarray(a)).to(device=device,
                                                     dtype=dtype)
                      for a in src["forcing"]))


def to_numpy(nt: NamedTuple) -> dict:
    """{field: np.ndarray} of a port NamedTuple, copied to the host."""
    return {name: getattr(nt, name).detach().cpu().numpy()
            for name in nt._fields}
