"""Post-processing / analysis layer (port of qgcm_tpu/analysis/, which is
NumPy and scipy host code, copied; the netCDF writer is the port's).

Replaces the k247 Ruby analysis stack (qgcm_k247.rb `K247_qgcm_data`,
qgcm_prep_k247.rb, prep_avg_*.rb) with NumPy on the netCDF outputs."""

from .core import QgcmData  # noqa: F401
from .prep import (unify_monit, average_more, cut_eddy,  # noqa: F401
                   hmax_series)
