"""Adjoint sensitivities: gradients through the model (port of
qgcm_tpu/adjoint.py).

Q-GCM has no adjoint. Here, as in qgcm_tpu, reverse-mode automatic
differentiation (torch.autograd) runs through the whole ocean-only
time loop: the leapfrog, the Arakawa Jacobian, the mixed layer, the
spectral PV inversion and the channel's constraint algebra. The fused
vorticity step stays the hand-written kernel in the forward pass on the
card; its gradient is that of its plain version, recomputed from the
step's inputs (ops.qgstep._Step), as qgcm_tpu differentiates its op
chain.

Memory: the runner's `remat` (models/stepper.remat_loop) checkpoints
pairs of substeps in nested levels, and `segment_steps` chains
segments on the host for horizons whose backward pass would not fit
the card.

    sens = ocean_sensitivity(model, layer1_energy_proxy(model))
    val, grads = sens(state0, (tauxo, tauyo, fnetoc), n_steps=1200)
    dL_dtaux = grads.forcing[0]   # (nypo, nxpo)

Distributed (`mesh`, `halo_variant`): every rank differentiates its
blocks' run through the mesh runner; the collectives' and the window
kernel's autograd rules (parallel/mesh.py, ops/qgstep.py) carry the
cotangents between the ranks, as XLA transposes qgcm_tpu's collectives.

    with distributed_session("gloo"):
        mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
        sens = ocean_sensitivity(model, obj, mesh=mesh,
                                 halo_variant="overlap")
        val, grads = sens(shard_tree(state0, mesh), mean_forcing, n)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .model import Model
from .models.ocean import _as_field, ocean_forcing_from_mean
from .models.stepper import make_ocean_only_runner, mesh_variants
from .parallel.mesh import gather_tree, replicated, shard_tree, zero_padding
from .state import OceanState

# the collective call site of the gradients' one all_reduce (Mesh.counts)
SUMS = "adjoint.sums"


class OceanSensitivity(NamedTuple):
    """Gradients of a scalar objective from ocean_sensitivity."""
    state0: OceanState      # dL/d(initial state), field by field
    forcing: tuple          # dL/d(tauxo, tauyo, fnetoc)


def _leaves(tensors):
    """Detached copies that require grad: the inputs of a backward pass."""
    return [t.detach().clone().requires_grad_() for t in tensors]


def _grads(outputs, inputs, grad_outputs=None):
    """d(outputs)/d(inputs), zeros where an input does not reach them.
    Outputs that depend on no input are left out."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs or
                                    [None] * len(outputs))
             if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], inputs,
                              grad_outputs=([g for _, g in pairs]
                                            if grad_outputs else None),
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


def ocean_sensitivity(model: Model, loss: Callable[[OceanState],
                                                   torch.Tensor],
                      remat=True, segment_steps: int = 0, mesh=None,
                      halo_variant=None):
    """dL/d(initial state, mean forcing) of an ocean-only run.

    loss: scalar function of the final OceanState. remat: as
    make_ocean_only_runner takes it (True: nested checkpoints of
    REMAT_LEVEL; an int: that fan-out; "dots": also keep the products
    and FFTs; False: keep everything). segment_steps > 0: host-level
    checkpoints: the forward pass keeps one state per segment in host
    memory (pinned on the card's host), then one backward pass per
    segment chains the cotangents from the last segment to the first;
    the gradient is the one-program gradient, and the card holds one
    segment's backward at a time.

    Returns fn(state0, (tauxo, tauyo, fnetoc), n_steps, step0=0) ->
    (loss value, OceanSensitivity). The forcing gradient is taken with
    respect to the mean fields (the avges.nc triple) through
    ocean_forcing_from_mean, so dL/dtauxo includes the Ekman velocity,
    curl and boundary stress-integral (txis/txin) pathways.

    mesh, halo_variant: the distributed adjoint (qgcm_tpu/adjoint.py:
    41-98), through make_ocean_only_runner(model, mesh, halo_variant,
    'a2a', remat): a mesh of any (y, x) shape made for the ocean's
    p-grid. state0 is then this rank's blocks (parallel/mesh.shard_tree
    on the mesh that models/stepper.mesh_variants gives: a channel on a
    mesh with x > 1 without a halo variant takes row blocks over all the
    ranks, parallel/mesh.ocean_mesh) and the mean forcing the whole
    fields on every rank; the forcing is derived from them whole and
    sharded. The final state is gathered, so `loss` sees the whole
    OceanState on every rank; its cotangent is seeded on rank 0 alone
    (parallel/mesh.py's convention for a value every rank computes the
    same). The value comes out the same on every rank; the gradient of
    state0 as this rank's blocks, zero on their padding; the gradients
    of the replicated leaves of state0 (its scalars and mode vectors) and
    of the forcing summed over the ranks by one all_reduce, the same bits
    on every rank. segment_steps chains blocks: each rank keeps its
    blocks' segment starts. A mesh without halo_variant, where qgcm_tpu
    differentiates its GSPMD partitioning, takes 'overlap'; without a
    mesh halo_variant is not read."""
    mesh, halo_variant = mesh_variants(model.cfg, mesh, halo_variant, None)
    run = make_ocean_only_runner(
        model, mesh=mesh, halo_variant=halo_variant, remat=remat)

    def forcing(mean_forcing):
        f = ocean_forcing_from_mean(model, *mean_forcing)
        return f if mesh is None else shard_tree(f, mesh)

    def value_and_grad(state0, mean_forcing, n_steps, step0, cot=None):
        """(loss, d/d state0, d/d forcing) of one program; with `cot` the
        cotangent of the final state replaces the loss (value None). On
        a mesh the gradients of replicated inputs are this rank's
        parts."""
        with torch.enable_grad():
            s0 = OceanState(*_leaves(state0))
            mf = _leaves(_as_field(model, x) for x in mean_forcing)
            st = run(s0, forcing(mf), n_steps, step0)
            if cot is None:
                val = loss(st if mesh is None else gather_tree(st, mesh))
                seed = (None if mesh is None else
                        [torch.ones_like(val) if mesh.rank == 0
                         else torch.zeros_like(val)])
                g = _grads([val], [*s0, *mf], seed)
                val = val.detach()
            else:
                val = None
                g = _grads(list(st), [*s0, *mf], list(cot))
        return val, OceanState(*g[:len(s0)]), tuple(g[len(s0):])

    def result(val, gs, gf):
        """The OceanSensitivity: on a mesh the replicated gradients summed
        over the ranks (one all_reduce) and the blocks' padding zero."""
        if mesh is not None:
            rep = [k for k, v in gs._asdict().items() if replicated(v)]
            parts = [getattr(gs, k) for k in rep] + list(gf)
            tot = mesh.all_reduce(torch.cat([t.reshape(-1) for t in parts]),
                                  SUMS)
            sums = [v.view_as(t) for v, t in zip(
                tot.split([t.numel() for t in parts]), parts)]
            gs = zero_padding(gs._replace(**dict(zip(rep, sums))), mesh)
            gf = tuple(sums[len(rep):])
        return val, OceanSensitivity(state0=gs, forcing=gf)

    def fn(state0, mean_forcing, n_steps: int, step0: int = 0):
        return result(*value_and_grad(state0, mean_forcing, n_steps, step0))

    if not segment_steps:
        return fn

    plain = make_ocean_only_runner(model, mesh=mesh,
                                   halo_variant=halo_variant)

    def to_host(st):
        return OceanState(*(torch.empty_like(
            t, device="cpu", pin_memory=t.is_cuda).copy_(t) for t in st))

    def to_device(st):
        return OceanState(*(t.to(model.device, non_blocking=True)
                            for t in st))

    def fn_seg(state0, mean_forcing, n_steps: int, step0: int = 0):
        if n_steps % segment_steps:
            raise ValueError(f"n_steps ({n_steps}) must be a multiple of "
                             f"segment_steps ({segment_steps})")
        k_segs = n_steps // segment_steps
        with torch.no_grad():
            f = forcing(mean_forcing)
            starts = [to_host(state0)]
            st = state0
            for k in range(k_segs - 1):
                st = plain(st, f, segment_steps, step0 + k * segment_steps)
                starts.append(to_host(st))
        val, cot, gmf = value_and_grad(
            to_device(starts[-1]), mean_forcing, segment_steps,
            step0 + (k_segs - 1) * segment_steps)
        for k in range(k_segs - 2, -1, -1):
            _, cot, gmf_k = value_and_grad(
                to_device(starts[k]), mean_forcing, segment_steps,
                step0 + k * segment_steps, cot=cot)
            gmf = tuple(a + b for a, b in zip(gmf, gmf_k))
        return result(val, cot, gmf)

    return fn_seg


def layer1_energy_proxy(model: Model):
    """Scalar objective: domain-mean layer-1 geostrophic kinetic energy
    density from the final pressure (u = -p_y/f0, v = p_x/f0):
    0.5 <|grad p|^2> / f0^2."""
    f0 = model.cfg.fnot
    dx = model.grids.dxo

    def loss(st: OceanState):
        p = st.po[0]
        px = (p[:, 1:] - p[:, :-1]) / dx
        py = (p[1:, :] - p[:-1, :]) / dx
        return 0.5 * (torch.mean(torch.square(px))
                      + torch.mean(torch.square(py))) / f0**2

    return loss


def transport_proxy(model: Model):
    """Scalar objective: zonal-mean zonal transport of layer 1 in a
    channel, <u1> = -<dp/dy>/f0 over the domain, the ACC transport
    analogue whose wind-stress sensitivity is usually asked for."""
    f0 = model.cfg.fnot
    dy = model.grids.dxo

    def loss(st: OceanState):
        p = st.po[0]
        return -torch.mean((p[1:, :] - p[:-1, :]) / dy) / f0

    return loss
