"""The device the port's entry points put their tensors on.

Every entry point that makes tensors (`model.build_model`, the
`convert.*_to_torch` converters, `solver.helmholtz.make_box_helmholtz`
and `make_cyclic_helmholtz`) defaults to the card, "cuda",
and runs on the CPU only when the caller asks for "cpu"; where CUDA is
absent a call for the card raises instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` ('cuda', 'cuda:n', 'cpu' or a torch.device) as a
    torch.device; raises RuntimeError if it is a CUDA device and CUDA is
    not available, ValueError if it is neither CUDA nor the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"qgcm_torch runs on cuda or cpu, not {device}")
    return device
