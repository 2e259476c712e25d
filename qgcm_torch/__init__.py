"""qgcm_torch: the PyTorch and CUDA port of qgcm_tpu.

The JAX package `qgcm_tpu` stays the reference; this package computes
the same model with PyTorch tensors and hand-written CUDA kernels for
NVIDIA Hopper (sm_90a). Module names mirror `qgcm_tpu`.

Precision policy, as in qgcm_tpu: model initialisation runs in float64
NumPy on the host and is moved to the device once; the stepped fields
take `ModelConfig.dtype`. Nothing here sets a global default dtype or
device: every tensor is made on the device `build_model` was given.

The port covers the ocean (box and zonally-cyclic channel), the
atmosphere, the air-sea coupling and the ocean-only, coupled and
atmosphere-only runners (config, grids, modes, radiation, topography,
both PV inversions, coupling, models/), ensembles and adjoint
sensitivities (models/ensemble.py, adjoint.py), the experiment driver
with its diagnostics, I/O, analysis and CLI, and, on row blocks of a
process group (and, for a box, on 2-D blocks of any (y, x) mesh;
parallel/), the ocean-only and coupled runners, the Driver and the
`run --mesh` and `ensemble --shard-members` commands.
Importing this package never imports JAX.
"""

from .config import (ModelConfig, OceanConfig, AtmosConfig,  # noqa: F401
                     MixedLayerConfig, RadiationConfig, SpongeConfig,
                     PRESETS)

__version__ = "0.1.0"
