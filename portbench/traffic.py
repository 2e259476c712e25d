"""The one generator of the benchmark's inputs: a traffic mix (the `mix`
of a cell's file, portbench/workloads/<cell>.json) and a seed give the
initial pressure of every member and the surface forcing, made on the
device in float64 and rounded once to the configuration's type.

A mix's parameters:
  members      trajectories stepped together (1: one trajectory)
  chunk        substeps of one runner call (the window's unit)
  eddy         {"ssh_amp": m, "l_efold": m, "shift": fraction}: a
               Gaussian SSH eddy (the shape of the k247 restart tool,
               src/k247_make_restart_q-gcm.F90:220-262) whose centre the
               seed moves by up to `shift` of the box from its middle
  wind         {"tau0": m^2 s^-2}: the double-gyre stress
               tau_x = -tau0 cos(2 pi y / L), tau_y = 0, no heat flux
  perturbation {"amp": m^2 s^-2, "n_smooth": passes}: members 1.. get a
               smooth noise of that RMS pressure, windowed to vanish on
               the solid walls (member 0 is the control)
  trace_chunks chunks profiled after the window of a --trace 1 run
In a zonally cyclic ocean the pressure's east column repeats its west
one, as the port and a reference keep it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GRAV = 9.8


def grid(m: dict) -> tuple:
    """(nl, nyp, nxp, nyt, nxt) of a configuration's ocean."""
    nxt, nyt = m["ndxr"] * m["nxaooc"], m["ndxr"] * m["nyaooc"]
    return m["ocean"]["nlo"], nyt + 1, nxt + 1, nyt, nxt


def eddy_centre(m: dict, t: dict, seed: int) -> tuple:
    """The eddy's centre (i_e, j_e), 1-based T-cell indices as the
    restart tool counts them, moved from the middle by the seed."""
    _, _, _, nyt, nxt = grid(m)
    shift = t["eddy"]["shift"]
    u = np.random.default_rng(seed).uniform(-shift, shift, size=2)
    return (nxt // 2 + int(round(u[0] * nxt)),
            nyt // 2 + int(round(u[1] * nyt)))


def _smooth(noise: torch.Tensor, passes: int) -> torch.Tensor:
    """`passes` 5-point averages with the edge values repeated."""
    for _ in range(passes):
        pad = F.pad(noise, (1, 1, 1, 1), mode="replicate")
        noise = 0.2 * (pad[..., 1:-1, 1:-1] + pad[..., :-2, 1:-1]
                       + pad[..., 2:, 1:-1] + pad[..., 1:-1, :-2]
                       + pad[..., 1:-1, 2:])
    return noise


def make_inputs(m: dict, t: dict, seed: int, device, dtype) -> dict:
    """The inputs of one run: po (M, nl, nyp, nxp), the stresses tauxo,
    tauyo (nyp, nxp) and the heat flux fnetoc (nyt, nxt), all of `dtype`
    on `device`."""
    f64 = torch.float64
    nl, nyp, nxp, nyt, nxt = grid(m)
    dx = m["ocean"]["dxo"]
    n_mem = t["members"]
    i_e, j_e = eddy_centre(m, t, seed)
    ii = (torch.arange(nxp, dtype=f64, device=device) + 1 - i_e) * dx
    jj = (torch.arange(nyp, dtype=f64, device=device) + 1 - j_e) * dx
    r2 = ii[None, :] ** 2 + jj[:, None] ** 2
    ssh = t["eddy"]["ssh_amp"] * torch.exp(-r2 / t["eddy"]["l_efold"] ** 2)
    po = torch.zeros((n_mem, nl, nyp, nxp), dtype=f64, device=device)
    po[:, 0] = GRAV * ssh
    if n_mem > 1:
        p = t["perturbation"]
        gen = torch.Generator(device=device).manual_seed(seed)
        noise = torch.randn((n_mem - 1, nl, nyp, nxp), generator=gen,
                            dtype=f64, device=device)
        noise = _smooth(noise, p["n_smooth"])
        noise /= noise.square().mean((-3, -2, -1), keepdim=True).sqrt()
        wy = torch.sin(torch.pi * torch.arange(nyp, dtype=f64,
                                               device=device) / (nyp - 1))
        wx = torch.sin(torch.pi * torch.arange(nxp, dtype=f64,
                                               device=device) / (nxp - 1))
        wy[0] = wy[-1] = wx[0] = wx[-1] = 0.0
        if m["cyclic_ocean"]:
            wx[:] = 1.0
        po[1:] += p["amp"] * noise * (wy[:, None] * wx[None, :])
    if m["cyclic_ocean"]:
        po[..., -1] = po[..., 0]
    yrel = torch.arange(nyp, dtype=f64, device=device) / nyt
    taux = -t["wind"]["tau0"] * torch.cos(2.0 * torch.pi * yrel)
    tauxo = taux[:, None].expand(nyp, nxp)
    return dict(po=po.to(dtype),
                tauxo=tauxo.to(dtype).contiguous(),
                tauyo=torch.zeros((nyp, nxp), dtype=dtype, device=device),
                fnetoc=torch.zeros((nyt, nxt), dtype=dtype, device=device))
