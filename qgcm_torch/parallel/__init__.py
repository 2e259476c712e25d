"""Multi-process decomposition of the ocean over torch.distributed (port
of qgcm_tpu/parallel): the process group (launch), the row and column
blocks and their collectives (mesh), the vorticity step's halo exchange
(halo) and the PV inversions' pencil transposes (spectral)."""
