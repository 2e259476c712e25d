"""Time stepping: the ocean-only, coupled and atmosphere-only runners
(port of qgcm_tpu/models/stepper.py).

The loops are plain Python; PyTorch runs each step's operations eagerly
on the model's device, and nothing in a loop waits for the device.

With `remat`, the ocean-only and coupled runners checkpoint their steps
for reverse-mode differentiation (adjoint.py) with
torch.utils.checkpoint, as qgcm_tpu's runners wrap their scans in
jax.checkpoint: the backward pass keeps a bounded number of states and
recomputes the steps between them. The forward values are the same
with and without it.

Leapfrog computational-mode suppression (q-gcm.F:1325-1366, 1370-1407):
the current time level is averaged with the lagged one, x <- (x + xm)/2,
after every ocean substep whose 0-based index n has n % 25 == 0, and
after every atmosphere step whose index has n % 100 == 0. NOT a
Robert-Asselin filter: the lagged level is left as it is, exactly as the
reference does.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from ..model import Model
from ..state import AtmosState, OceanState, OceanForcing
from .atmos import make_atmos_step
from .ocean import _as_field, make_ocean_step
from ..parallel.mesh import ocean_mesh

OCEAN_AVG_PERIOD = 25   # ocean substeps between time-level averagings
ATMOS_AVG_PERIOD = 100  # atmos steps between averagings

# Per-level fan-out of the nested checkpoints (qgcm_tpu/models/
# stepper.py:82-90): a run of N units nests ceil(log_LEVEL N) levels, so
# the backward pass keeps about levels x LEVEL states and recomputes each
# level's chunks once.
REMAT_LEVEL = 16

# remat="dots" keeps the outputs of these operators, the matrix products
# and FFTs of the spectral solves, and recomputes the rest: the
# counterpart of qgcm_tpu's dots_saveable policy, which keeps the MXU
# products. On a mesh the rest includes the collectives (the c10d ops)
# and their staging copies: a recomputation replays them, as it replays
# the ranks' other collectives.
_DOTS = frozenset(getattr(torch.ops.aten, name) for name in (
    "mm", "bmm", "addmm", "baddbmm", "_fft_r2c", "_fft_c2r", "_fft_c2c"))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, dots: bool = False, whole: bool = False):
    """fn under non-reentrant checkpointing (which nests); with `dots`
    the products and FFTs are saved (_DOTS). `whole`: a recomputation
    replays all of fn, not only as far as the last tensor the backward
    needs (the early stop), so that every rank of a mesh replays every
    collective of fn whatever its own last saved tensor."""
    kw = {}
    if dots:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(carry):
        with set_checkpoint_early_stop(not whole):
            return checkpoint(fn, carry, use_reentrant=False, **kw)
    return run


def remat_loop(body, carry, length: int, remat=False, whole: bool = False):
    """`length` calls carry = body(carry), checkpointed as qgcm_tpu's
    _remat_scan nests its scans (stepper.py:93-122). remat False: plain.
    True, "dots" or an int >= 2 (the per-level fan-out, else
    REMAT_LEVEL): each call of body is checkpointed ("dots": saving the
    products and FFTs), and runs longer than a level are cut into
    checkpointed chunks of `level` units, recursively. `whole`: every
    recomputation replays its whole chunk (_checkpointed), as a mesh
    runner's ranks need."""
    if not remat:
        for _ in range(length):
            carry = body(carry)
        return carry
    level = (remat if isinstance(remat, int) and not isinstance(remat, bool)
             and remat >= 2 else REMAT_LEVEL)

    def run(fn, carry, n):
        if n > level:
            chunks, n = divmod(n, level)

            def chunk(c):
                for _ in range(level):
                    c = fn(c)
                return c

            carry = run(_checkpointed(chunk, whole=whole), carry, chunks)
        for _ in range(n):
            carry = fn(carry)
        return carry

    return run(_checkpointed(body, remat == "dots", whole), carry, length)


def average_ocean_levels(st: OceanState) -> OceanState:
    """x <- (x + xm)/2 for the current time level only
    (q-gcm.F:1328-1366, constraint variables included)."""
    return st._replace(
        po=0.5 * (st.po + st.pom),
        qo=0.5 * (st.qo + st.qom),
        sst=0.5 * (st.sst + st.sstm),
        dpioc=0.5 * (st.dpioc + st.dpiocp),
        ocncs=0.5 * (st.ocncs + st.ocncsp),
        ocncn=0.5 * (st.ocncn + st.ocncnp),
    )


def average_atmos_levels(st: AtmosState) -> AtmosState:
    """The atmospheric analogue (q-gcm.F:1370-1407)."""
    return st._replace(
        pa=0.5 * (st.pa + st.pam),
        qa=0.5 * (st.qa + st.qam),
        ast=0.5 * (st.ast + st.astm),
        hmixa=0.5 * (st.hmixa + st.hmixam),
        dpiat=0.5 * (st.dpiat + st.dpiatp),
        atmcs=0.5 * (st.atmcs + st.atmcsp),
        atmcn=0.5 * (st.atmcn + st.atmcnp),
    )


def mesh_variants(cfg, mesh, halo_variant, spectral_variant):
    """(mesh, halo_variant) of a mesh run as the port takes it. qgcm_tpu
    leaves what a variant does not name to GSPMD's partitioning, which
    has no PyTorch counterpart and computes the same numbers: here
    halo_variant None takes 'overlap' (parallel/halo.py) and
    spectral_variant None 'a2a' (parallel/spectral.py, the only one).
    Given no halo variant, and always in an atmosphere-only case, the
    ocean's grid takes parallel/mesh.ocean_mesh(mesh, cfg): a channel on
    a mesh with x > 1 runs on row blocks over all of mesh's ranks, as
    qgcm_tpu runs it under GSPMD. A channel given a halo variant on such
    a mesh raises where the substep is built, as qgcm_tpu's halo path
    does (qgcm_tpu/parallel/halo.py:379-385)."""
    if mesh is None:
        return None, halo_variant
    if spectral_variant not in (None, "a2a"):
        raise ValueError(f"unknown spectral_variant {spectral_variant!r}: "
                         "the port's is 'a2a' (None takes it)")
    if halo_variant is None or cfg.atmos_only:
        mesh = ocean_mesh(mesh, cfg)
    return mesh, halo_variant or "overlap"


def make_cycle_head(model: Model, mesh=None, halo_variant=None,
                    spectral_variant=None):
    """The head of a coupling cycle (the reference's mod(nt,nstr)==1
    block, q-gcm.F:1222-1249), shared by the runners and the Driver.

    Returns head(ocean, atmos, ofor, afor, n, on_substep=None,
    sst_mean=None) -> (ocean, ofor, afor) for the cycle that starts at
    atmosphere step n (a multiple of nstr): coupled, xforc from the
    lagged states and one ocean substep under the new ocean forcing;
    ocean-only, one substep under the static `ofor`; atmosphere-only,
    xforc over the prescribed SST `sst_mean` (a tensor of the model's
    dtype on its device).
    `on_substep(ocean, ofor)` sees the state right after the substep;
    then the ocean's time levels are averaged when the cycle index
    n // nstr is a multiple of OCEAN_AVG_PERIOD.

    With `mesh` (a mesh made for the ocean's p-grid, of any (y, x)
    shape) the ocean's state and forcing are this rank's blocks
    (parallel/mesh.py) on the mesh that mesh_variants gives, and the
    atmosphere's state and forcing its row blocks on
    parallel/mesh.atmos_mesh(mesh, cfg); an atmosphere-only head takes as
    `sst_mean` the rank's block of the prescribed SST. The substep is the
    decomposed one (make_ocean_step's halo path) and xforc the decomposed
    one (coupling.make_xforc); a variant not given takes mesh_variants'
    default."""
    from ..coupling import make_xforc
    cfg = model.cfg
    has_oc, has_at = not cfg.atmos_only, not cfg.ocean_only
    nstr = cfg.nstr
    mesh, halo_variant = mesh_variants(cfg, mesh, halo_variant,
                                       spectral_variant)
    halo = None if mesh is None else (mesh, halo_variant)
    ostep = make_ocean_step(model, halo=halo) if has_oc else None
    xforc = make_xforc(model, mesh=mesh) if has_at else None

    def head(ocean, atmos, ofor, afor, n: int, on_substep=None,
             sst_mean=None):
        if has_at and has_oc:
            ofor, afor, _ = xforc(atmos.pam, ocean.pom, ocean.sstm,
                                  atmos.astm, atmos.hmixam)
        elif has_at:
            _, afor, _ = xforc(atmos.pam, None, sst_mean, atmos.astm,
                               atmos.hmixam)
        if has_oc:
            ocean, _diags = ostep(ocean, ofor)
            if on_substep is not None:
                on_substep(ocean, ofor)
            if (n // nstr) % OCEAN_AVG_PERIOD == 0:
                ocean = average_ocean_levels(ocean)
        return ocean, ofor, afor

    return head


def make_atmos_segment(model: Model, mesh=None):
    """`length` atmosphere steps under one forcing, shared by the runners
    and the Driver (the partial cycles of an exact-cadence Driver run
    included). Returns segment(atmos, afor, n0, length, on_step=None)
    -> atmos: step n0 + i is followed by the time-level averaging when
    (n0 + i) % ATMOS_AVG_PERIOD == 0 (q-gcm.F:1370-1407), then by
    on_step(atmos, n0 + i). With `mesh` the atmosphere and its forcing
    are this rank's row blocks (models/atmos.make_atmos_step)."""
    astep = make_atmos_step(model, mesh)

    def segment(atmos, afor, n0: int, length: int, on_step=None):
        for i in range(length):
            atmos, _diags = astep(atmos, afor)
            if (n0 + i) % ATMOS_AVG_PERIOD == 0:
                atmos = average_atmos_levels(atmos)
            if on_step is not None:
                on_step(atmos, n0 + i)
        return atmos

    return segment


def make_ocean_only_runner(model: Model, mesh=None, halo_variant=None,
                           spectral_variant=None, remat=False):
    """Returns run(state, forcing, n_steps, step0=0) -> state.

    `step0` is the 0-based index of the first ocean substep taken by
    this call, so chunked host loops keep the averaging cadence aligned.
    The loop is plain Python over single substeps (cycle heads of an
    ocean-only model); PyTorch runs each substep's operations eagerly on
    the model's device.

    With `mesh` (parallel/mesh.py, a mesh made for the ocean's p-grid, of
    any (y, x) shape) the state and forcing are this rank's blocks
    (parallel/mesh.shard_tree on the mesh that mesh_variants gives) and
    so is the result: the vorticity step exchanges its ghosts by
    `halo_variant` ('staged', 'deep' or 'overlap', parallel/halo.py) and
    the inversions transpose by all_to_all (spectral_variant='a2a',
    parallel/spectral.py). Where qgcm_tpu leaves a variant to GSPMD's
    partitioning (None), the port takes 'overlap' and 'a2a', and a
    channel on a mesh with x > 1 runs on row blocks over all the mesh's
    ranks (parallel/mesh.ocean_mesh); given a halo variant there it
    raises, as qgcm_tpu's halo path does. Without a mesh the two
    variants are not read, as in qgcm_tpu.

    remat (remat_loop): False stores every step for a backward pass;
    True, "dots" or an int checkpoints pairs of substeps, as qgcm_tpu's
    scan body is a pair. On a mesh every rank recomputes its blocks'
    pairs, replaying their collectives in the forward's order (the
    backward's own collectives are the rules of parallel/mesh.py)."""
    mesh, halo_variant = mesh_variants(model.cfg, mesh, halo_variant,
                                       spectral_variant)
    head = make_cycle_head(model, mesh, halo_variant)
    nstr = model.cfg.nstr

    def run(state: OceanState, forcing: OceanForcing, n_steps: int,
            step0: int = 0) -> OceanState:
        def one(state, n):
            return head(state, None, forcing, None, n * nstr)[0]

        def pair(carry):
            state, n = carry
            return one(one(state, n), n + 1), n + 2

        if not remat:
            for n in range(step0, step0 + n_steps):
                state = one(state, n)
            return state
        pairs, rem = divmod(n_steps, 2)
        state, n = remat_loop(pair, (state, step0), pairs, remat,
                              whole=mesh is not None)
        return one(state, n) if rem else state

    return run


def _split_cycles(n_steps: int, step0: int, nstr: int) -> range:
    """The coupling cycles of a run of n_steps atmosphere steps from
    step0: the cycle-structured runners advance in whole cycles (xforc,
    then nstr atmosphere steps), so both must be multiples of nstr."""
    if n_steps % nstr:
        raise ValueError(
            f"n_steps ({n_steps}) must be a multiple of nstr ({nstr}) "
            "for the cycle-structured coupled/atmos-only runners")
    if step0 % nstr:
        raise ValueError(f"step0 ({step0}) must be a multiple of "
                         f"nstr ({nstr})")
    return range(step0 // nstr, (step0 + n_steps) // nstr)


def make_atmos_only_runner(model: Model):
    """Atmosphere-only mode: the ocean surface is a prescribed mean SST
    field (reference q-gcm.F:752-826 reads it from avges.nc). xforc is
    re-evaluated every nstr steps exactly as when coupled.

    Returns run(state, sst_mean, n_steps, step0=0) -> state, n_steps
    and step0 counting atmosphere steps, both multiples of nstr."""
    head = make_cycle_head(model)
    segment = make_atmos_segment(model)
    nstr = model.cfg.nstr

    def run(state: AtmosState, sst_mean, n_steps: int,
            step0: int = 0) -> AtmosState:
        cycles = _split_cycles(n_steps, step0, nstr)
        sst_mean = _as_field(model, sst_mean)
        for c in cycles:
            _, _, afor = head(None, state, None, None, c * nstr,
                              sst_mean=sst_mean)
            state = segment(state, afor, c * nstr, nstr)
        return state

    return run


def make_coupled_runner(model: Model, remat=False, mesh=None,
                        halo_variant=None, spectral_variant=None):
    """Fully coupled ocean-atmosphere stepping (main loop
    q-gcm.F:1220-1491), one coupling cycle at a time: xforc from the
    lagged states, one ocean substep with dto = nstr*dta, then nstr
    atmosphere steps under that cycle's forcing.

    Returns run(ocean, atmos, n_steps, step0=0) -> (ocean, atmos).
    `n_steps` counts ATMOSPHERIC steps; step0 keeps the coupling and
    averaging cadences aligned across chunks. Both are multiples of
    nstr. remat (remat_loop) checkpoints whole coupling cycles.

    With `mesh` (a mesh made for the ocean's p-grid, as the ocean-only
    runner takes it; qgcm_tpu/models/stepper.py:255-329) the ocean is
    this rank's blocks in and out (parallel/mesh.shard_tree, on the mesh
    mesh_variants gives: a channel's with no halo variant is
    parallel/mesh.ocean_mesh's rows), stepped by the decomposed substep
    under the decomposed xforc (make_cycle_head), and the atmosphere is
    this rank's row blocks in and out (shard_tree on
    parallel/mesh.atmos_mesh(mesh, cfg)), stepped on them. halo_variant
    and spectral_variant are the ocean-only mesh runner's. With remat the
    mesh runner is the coupled model's distributed adjoint (qgcm_tpu's,
    under jax.grad): every rank
    recomputes its blocks' cycles, replaying their collectives in the
    forward's order, and the collectives' and the window kernel's
    autograd rules (parallel/mesh.py, ops/qgstep.py) carry the
    cotangents between the ranks."""
    mesh, halo_variant = mesh_variants(model.cfg, mesh, halo_variant,
                                       spectral_variant)
    head = make_cycle_head(model, mesh, halo_variant)
    segment = make_atmos_segment(model, mesh)
    nstr = model.cfg.nstr

    def cycle(carry):
        ocean, atmos, c = carry
        ocean, _, afor = head(ocean, atmos, None, None, c * nstr)
        return ocean, segment(atmos, afor, c * nstr, nstr), c + 1

    def run(ocean: OceanState, atmos: AtmosState, n_steps: int,
            step0: int = 0):
        cycles = _split_cycles(n_steps, step0, nstr)
        ocean, atmos, _ = remat_loop(cycle, (ocean, atmos, cycles.start),
                                     len(cycles), remat,
                                     whole=mesh is not None)
        return ocean, atmos

    return run
