"""Diagnostics: validity scans, CFL, monitoring/energy budget, running
means, covariances, area averages and the dq/dt decomposition (port of
qgcm_tpu/diags). Each runs on the model's device; the writers copy to
the host at write time."""

from .valids import valids, ValidityReport  # noqa: F401
from .cfl import cfl_numbers  # noqa: F401
from .monitor import compute_monitor, MonitorWriter  # noqa: F401
