"""Ensemble (perturbed initial condition) runs: members as a leading
batch axis (port of qgcm_tpu/models/ensemble.py).

The reference runs one trajectory per job; here the members of an
ensemble ride a leading axis of every state tensor through the same
runner: `make_ensemble_runner` maps the single-trajectory runners
(models/stepper.py) over the members with torch.func.vmap. The fused
vorticity step takes the member axis natively (ops.qgstep's vmap rule
folds it into the kernel's member axis), so on the card each substep is
one kernel launch for all members, bit for bit the per-member launches.
qgcm_tpu instead switches its Pallas kernel off for members, because
Mosaic's batching corrupted their trajectories
(qgcm_tpu/models/ensemble.py:249-261).

    model   = build_model(cfg)
    control = init_ocean_state(model, po=eddy_pressure(cfg))
    gen     = torch.Generator().manual_seed(0)
    members = perturbed_ocean_members(model, control, gen, 8)
    members = make_ensemble_runner(model)(members, forcing, 1200)
    sst_spread = ensemble_std(members).sst

Perturbations follow qgcm_tpu: a smooth pressure perturbation that
vanishes on the solid walls is added to both leapfrog time levels, and
PV and the constraint values are derived again from the perturbed
pressures as a restart does (q-gcm.F:715-750). torch's generators do
not reproduce jax.random: the same seed gives other members than
qgcm_tpu's, with the same properties.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..model import Model
from ..state import AtmosState, OceanState
from .atmos import init_atmos_state
from .ocean import init_ocean_state
from .stepper import make_coupled_runner, make_ocean_only_runner

# the warning torch.func.vmap gives when it runs an operator without a
# batching rule member by member
SLOW_VMAP = "There is a performance drop"


# ----------------------------------------------------------------------
# the member axis
# ----------------------------------------------------------------------

def stack_members(states):
    """One state whose tensors carry a leading member axis, from a list
    of per-member states."""
    return type(states[0])(*(torch.stack(xs) for xs in zip(*states)))


def member(states, i: int):
    """Member i of a stacked ensemble."""
    return type(states)(*(x[i] for x in states))


def n_members(states) -> int:
    return int(states[0].shape[0])


def ensemble_mean(states):
    """The member mean, a state of one member's shapes."""
    return type(states)(*(x.mean(dim=0) for x in states))


def ensemble_std(states):
    """The members' (population) standard deviation: the spread."""
    return type(states)(*(x.std(dim=0, correction=0) for x in states))


def spread_rms(states, field: str = "po") -> float:
    """RMS ensemble spread of one state field, the usual summary curve of
    a predictability experiment (one scalar comes to the host)."""
    sd = getattr(states, field).std(dim=0, correction=0)
    return float(torch.sqrt(torch.mean(torch.square(sd))))


# ----------------------------------------------------------------------
# perturbed initial conditions
# ----------------------------------------------------------------------

def _smooth_noise(generator: torch.Generator, shape, n_smooth: int):
    """Unit-RMS Gaussian noise (float64, on the generator's device)
    smoothed by n_smooth 5-point passes with edge values repeated, so
    that the perturbation sits at resolved scales rather than at the
    grid scale, which the del4 viscosity would remove in a few steps."""
    noise = torch.randn(shape, generator=generator, dtype=torch.float64,
                        device=generator.device)
    for _ in range(n_smooth):
        pad = F.pad(noise, (1, 1, 1, 1), mode="replicate")
        noise = 0.2 * (pad[:, 1:-1, 1:-1] + pad[:, :-2, 1:-1]
                       + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2]
                       + pad[:, 1:-1, 2:])
    return noise / torch.sqrt(torch.mean(torch.square(noise)))


def _boundary_window(cfg) -> np.ndarray:
    """(1, nypo, nxpo) window that vanishes on the solid p-grid walls
    (all four of a box ocean; the zonal ones of a channel), so that the
    perturbed pressure keeps the wall conditions the constraint algebra
    assumes."""
    wy = np.sin(np.pi * np.arange(cfg.nypo) / (cfg.nypo - 1))
    wy[0] = wy[-1] = 0.0          # exact zeros (sin(pi) ~ 1e-16)
    if cfg.cyclic_ocean:
        wx = np.ones(cfg.nxpo)
    else:
        wx = np.sin(np.pi * np.arange(cfg.nxpo) / (cfg.nxpo - 1))
        wx[0] = wx[-1] = 0.0
    return np.outer(wy, wx)[None, :, :]


def _perturbations(win: torch.Tensor, cyclic: bool, generator, shape, m,
                   amp, keep_first, n_smooth, device):
    """The noise of each member (None for the control member 0). In a
    cyclic fluid the duplicated east column is the west one bit for bit:
    the spectral solve is exactly cyclic, so a perturbation that broke
    the identification would be projected out and q would disagree with
    qcomp(p)."""
    for i in range(m):
        if i == 0 and keep_first:
            yield None
            continue
        noise = amp * win * _smooth_noise(generator, shape,
                                          n_smooth).to(device)
        if cyclic:
            noise[..., -1] = noise[..., 0]
        yield noise


def perturbed_ocean_members(model: Model, base: OceanState,
                            generator: torch.Generator, m: int,
                            amp: float = 1.0e-3, keep_first: bool = True,
                            n_smooth: int = 4) -> OceanState:
    """An m-member ocean ensemble around `base`, stacked. amp is the RMS
    pressure perturbation (m^2 s^-2; 1 cm of SSH is about 0.1 at
    mid-latitude f0). The same smooth windowed field is added to po and
    pom, then PV and the constraint values are derived per member by
    init_ocean_state. With keep_first, member 0 is `base` itself (the
    control). The configuration needs some dissipation (ah4oc or bottom
    drag): in an inviscid set-up the broadband noise piles up at the grid
    scale (qgcm_tpu/models/ensemble.py:130-136)."""
    cfg = model.cfg
    win = torch.as_tensor(_boundary_window(cfg), device=model.device)
    members = []
    for noise in _perturbations(win, cfg.cyclic_ocean, generator,
                                tuple(base.po.shape), m, amp, keep_first,
                                n_smooth, model.device):
        if noise is None:
            members.append(base)
            continue
        noise = noise.to(base.po.dtype)
        members.append(init_ocean_state(
            model, po=base.po + noise, pom=base.pom + noise,
            sst=base.sst, sstm=base.sstm))
    return stack_members(members)


def perturbed_atmos_members(model: Model, base: AtmosState,
                            generator: torch.Generator, m: int,
                            amp: float = 1.0e-2, keep_first: bool = True,
                            n_smooth: int = 4) -> AtmosState:
    """The atmosphere's counterpart, for coupled ensembles (windowed in y
    only: the atmosphere is always zonally cyclic). amp defaults larger
    because atmospheric pressures are O(10^2) m^2 s^-2."""
    cfg = model.cfg
    wy = np.sin(np.pi * np.arange(cfg.nypa) / (cfg.nypa - 1))
    wy[0] = wy[-1] = 0.0
    win = torch.as_tensor(wy[None, :, None], device=model.device)
    members = []
    for noise in _perturbations(win, True, generator, tuple(base.pa.shape),
                                m, amp, keep_first, n_smooth, model.device):
        if noise is None:
            members.append(base)
            continue
        noise = noise.to(base.pa.dtype)
        members.append(init_atmos_state(
            model, pa=base.pa + noise, pam=base.pam + noise,
            ast=base.ast, astm=base.astm, hmixa=base.hmixa,
            hmixam=base.hmixam))
    return stack_members(members)


# ----------------------------------------------------------------------
# the runners
# ----------------------------------------------------------------------

@contextlib.contextmanager
def strict_vmap():
    """Turn torch.func.vmap's warning that it steps an operator member by
    member (no batching rule) into an error: on the ensemble path every
    operator batches."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=SLOW_VMAP)
        yield


def ensemble_mesh(size: int = None):
    """The 1-D member mesh (qgcm_tpu's ensemble_mesh over devices): the
    first `size` ranks of the process group (all of them by default),
    each stepping its block of the members. Every rank calls it (a
    smaller mesh makes a process group of its ranks); a rank outside the
    mesh gets None."""
    import torch.distributed as dist
    from ..parallel.mesh import Mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    size = world if size is None else size
    if not 1 <= size <= world:
        raise ValueError(f"a member mesh of {size} ranks in a group of "
                         f"{world}")
    if size == world:
        return Mesh((size, 1))
    group = dist.new_group(list(range(size)))
    return Mesh((size, 1), group=group) if dist.get_rank() < size else None


def _check_divisible(members, mesh):
    m = n_members(members)
    nd = mesh.size
    if m % nd:
        raise ValueError(
            f"n_members ({m}) must be a multiple of the member-mesh "
            f"device count ({nd})")


def shard_members(members, mesh):
    """This rank's block of a stacked ensemble on a member mesh: members
    [r*b, (r+1)*b) of b = M / ranks. Every rank must hold the same whole
    ensemble, as perturbed_*_members make it from the same generator
    seed (qgcm_tpu asks the same of every process)."""
    _check_divisible(members, mesh)
    b = n_members(members) // mesh.size
    return type(members)(*(x[mesh.rank * b:(mesh.rank + 1) * b].clone()
                           for x in members))


def gather_members(block, mesh):
    """The whole ensemble on every rank of a member mesh from each rank's
    block (shard_members' inverse), in one all_gather."""
    flat = torch.cat([x.reshape(-1) for x in block])
    parts = [p.split([x.numel() for x in block])
             for p in mesh.all_gather(flat, "ensemble.gather")]
    return type(block)(*(torch.cat([p[k].reshape(x.shape) for p in parts])
                         for k, x in enumerate(block)))


def make_ensemble_runner(model: Model, kind: str = None, mesh=None):
    """The single-trajectory runners of models/stepper.py mapped over a
    leading member axis with torch.func.vmap; the forcing is shared.

    kind: "ocean" (ocean-only; the default when cfg.ocean_only) or
    "coupled". Returns run(members, forcing, n_steps, step0=0) for
    "ocean", run(ocean_members, atmos_members, n_steps, step0=0) ->
    (ocean, atmos) for "coupled", with the runners' step units. An
    operator without a batching rule raises (strict_vmap).

    mesh: a member mesh (ensemble_mesh; the member count a multiple of
    its ranks). Each call then takes the whole ensemble on every rank,
    steps this rank's block of members (shard_members) with no
    collective, and returns the whole ensemble again, gathered in one
    all_gather at its end (gather_members)."""
    if kind is None:
        kind = "ocean" if model.cfg.ocean_only else "coupled"
    if kind == "ocean":
        run1 = make_ocean_only_runner(model)

        def body(members, forcing, n_steps, step0):
            with strict_vmap():
                return (torch.func.vmap(
                    lambda s: run1(s, forcing, n_steps, step0))(members),)
    elif kind == "coupled":
        run1 = make_coupled_runner(model)

        def body(oc_members, at_members, n_steps, step0):
            with strict_vmap():
                return torch.func.vmap(
                    lambda o, a: run1(o, a, n_steps, step0))(oc_members,
                                                             at_members)
    else:
        raise ValueError(f"unknown ensemble kind {kind!r}")

    def run(members, other, n_steps: int, step0: int = 0):
        # `other`: the shared forcing ("ocean") or the atmosphere's
        # members ("coupled")
        if mesh is None:
            out = body(members, other, n_steps, step0)
        else:
            if kind == "coupled":
                other = shard_members(other, mesh)
            out = body(shard_members(members, mesh), other, n_steps, step0)
            out = tuple(gather_members(o, mesh) for o in out)
        return out[0] if kind == "ocean" else out

    return run
