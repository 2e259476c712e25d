"""NetCDF I/O matching the reference Q-GCM file schemas (nc_subs.F);
port of qgcm_tpu/io. Host code: the writers copy device tensors to the
host at write time."""

from .restart import (save_restart, load_restart,  # noqa: F401
                      load_restart_forcing)
from .snapshots import OceanSnapshots, AtmosSnapshots  # noqa: F401
from .forcing import (read_mean_forcing, write_mean_forcing,  # noqa: F401
                      read_mean_sst)
