"""What each rank runs in the multi-process tests of qgcm_torch.parallel
(tests/test_torch_parallel_*.py), and the inputs both those ranks and
the tests build. The ranks are started with the "spawn" method
(qgcm_torch.parallel.launch.spawn_ranks), so this module imports only
torch, numpy and qgcm_torch: never JAX, never qgcm_tpu."""

import importlib
import os

import numpy as np
import torch

import qgcm_torch.config
from qgcm_torch.generators import double_gyre_windstress, eddy_pressure
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import (_oml, init_ocean_state,
                                     ocean_forcing_from_mean, qgstep_consts)
from qgcm_torch.parallel.mesh import (Mesh, gather, gather_tree, make_mesh,
                                      shard, shard_tree)


def small_cfg(cyclic=False, sponge=False, nyaooc=12, nxaooc=24,
              cfgmod=qgcm_torch.config):
    """The ocean of tests/test_halo.py:31-45 and tests/test_sharding.py
    (2 layers, 49 x 25 p-points at nyaooc 12), optionally with the k247
    sponge, in the config module `cfgmod` (the port's, or qgcm_tpu's
    where a test passes it)."""
    return cfgmod.ModelConfig(
        nxta=nxaooc, nyta=24, nxaooc=nxaooc, nyaooc=nyaooc, ndxr=2,
        fnot=5.92e-5, beta=2.08e-11,
        ocean=cfgmod.OceanConfig(nlo=2, dxo=20e3, delek=2.0,
                                 hoc=(800.0, 3200.0), gpoc=(0.01,),
                                 tabsoc=(287.0, 282.0), ah2oc=(0.0, 0.0),
                                 ah4oc=(1e10, 1e10)),
        ocean_only=True, cyclic_ocean=cyclic,
        sponge=cfgmod.SpongeConfig(enabled=sponge)).validate()


def seeded_state(cfg, seed=0):
    """Model (CPU, float64), state and forcing: the eddy of
    tests/test_halo.py with seeded noise on po, pom and the SST (so that
    no time level equals another), under the double-gyre wind."""
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(seed)
    po = eddy_pressure(cfg)
    po = po + 0.02 * np.abs(po).max() * rng.standard_normal(po.shape)
    pom = po + 0.01 * np.abs(po).max() * rng.standard_normal(po.shape)
    if cfg.cyclic_ocean:
        po[..., -1], pom[..., -1] = po[..., 0], pom[..., 0]
    sst = model.rad.sstbar[:, None] + rng.standard_normal(
        (cfg.nyto, cfg.nxto))
    st = init_ocean_state(model, po=po, pom=pom, sst=sst,
                          sstm=sst + 0.1 * rng.standard_normal(sst.shape))
    f = ocean_forcing_from_mean(model,
                                *double_gyre_windstress(cfg, model.grids))
    return model, st, f


def halo_args(cfg, seed=0):
    """The fused step's arguments at the seeded state."""
    model, st, f = seeded_state(cfg, seed)
    entoc = _oml(model, st, f)[2]
    return (st.pom, st.po, st.qo, st.qom, f.wekpo, entoc, model.r_spl,
            qgstep_consts(cfg, model.grids), cfg.ocean.ah2oc,
            cfg.ocean.ah4oc)


def _grid_mesh(shape, grid):
    """A rows mesh of the ranks for shape 'rows' or None, else a mesh of
    that (my, mx) shape."""
    if shape in ("rows", None):
        return make_mesh(rows_only=True, grid=grid)
    return Mesh(shape, grid=grid)


def halo_rank(cases):
    """For each case (cyclic, sponge, mesh shape: 'rows' or (my, mx),
    variants): the gathered qgstep_halo of every variant and its
    collective counts, or the error it raised. Rank 0 returns them."""
    from qgcm_torch.parallel.halo import qgstep_halo
    torch.set_num_threads(1)
    out = []
    for cyclic, sponge, shape, variants in cases:
        cfg = small_cfg(cyclic, sponge)
        args = halo_args(cfg)
        grid = (cfg.nypo, cfg.nxpo)
        mesh = _grid_mesh(shape, grid)
        blocks = [None if a is None else shard(a, mesh) for a in args[:7]]
        res = {}
        for v in variants:
            mesh.counts.clear()
            try:
                q = qgstep_halo(*blocks, *args[7:], cyclic=cyclic,
                                sponge=sponge, mesh=mesh, variant=v)
            except ValueError as e:
                res[v] = ("raised", str(e))
                continue
            counts = dict(mesh.counts)
            res[v] = ("ok", gather(q, mesh, site="test").numpy(), counts)
        out.append(res)
    return out if torch.distributed.get_rank() == 0 else None


def solver_rng_rhs(kind, nyp, nxp, seed):
    rhs = np.random.default_rng(seed).standard_normal((3, nyp, nxp))
    if kind == "cyclic":
        rhs[..., -1] = rhs[..., 0]
    return rhs


RDM2 = np.array([0.0, 2.3, 7.7])


def base_solver(kind, nyp, nxp, ytransform="fft"):
    """The port's single-device solver of tests/test_spectral.py's
    cases: dx 0.7, dy 0.9, rdm2 RDM2, float64 on the CPU."""
    from qgcm_torch.solver.helmholtz import (make_box_helmholtz,
                                             make_cyclic_helmholtz)
    if kind == "box":
        return make_box_helmholtz(nxp, nyp, 0.7, 0.9, RDM2, device="cpu")
    return make_cyclic_helmholtz(nxp, nyp, 0.7, 0.9, RDM2, device="cpu",
                                 ytransform=ytransform)


def solver_rank(cases, shape=None):
    """For each case (kind, nyp, nxp, ytransform, seed): the sharded solve
    on a rows mesh of the ranks (or on a mesh of `shape`) gathered whole,
    and for the box the spectrum (its column chunks gathered) with its
    padded columns."""
    from qgcm_torch.parallel.spectral import (ShardedBoxHelmholtz,
                                              ShardedCyclicHelmholtz)
    torch.set_num_threads(1)
    out = []
    for kind, nyp, nxp, ytransform, seed in cases:
        base = base_solver(kind, nyp, nxp, ytransform)
        mesh = _grid_mesh(shape, (nyp, nxp))
        rhs = shard(torch.from_numpy(solver_rng_rhs(kind, nyp, nxp, seed)),
                    mesh)
        if kind == "box":
            sh = ShardedBoxHelmholtz(base, mesh)
            spec = sh.forward(rhs) / sh._denom()
            sol = sh.inverse(spec)
            spec = torch.cat(mesh.all_gather(spec, "test"), dim=-1)
        else:
            sh = ShardedCyclicHelmholtz(base, mesh)
            sol, spec = sh.solve(rhs), None
        res = dict(sol=gather(sol, mesh, site="test").numpy(),
                   pad_zero=block_padding_zero(sol, mesh, nyp, nxp),
                   a2a=mesh.counts["spectral.a2a"])
        if spec is not None:
            res["spec"] = spec.numpy()
        out.append(res)
    return out if torch.distributed.get_rank() == 0 else None


def runner_rank(cases, shape=None):
    """For each case (cyclic, variant, n_steps, nyaooc[, nxaooc]): the
    seeded state run n_steps substeps by the sharded runner on a rows
    mesh of the ranks (or on a mesh of `shape`), gathered whole, with the
    collective counts per substep and qgstep's launches."""
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep
    torch.set_num_threads(1)
    out = []
    for cyclic, variant, n_steps, nyaooc, *nx in cases:
        cfg = small_cfg(cyclic, nyaooc=nyaooc, nxaooc=nx[0] if nx else 24)
        model, st, f = seeded_state(cfg)
        mesh = _grid_mesh(shape, (cfg.nypo, cfg.nxpo))
        run = make_ocean_only_runner(model, mesh=mesh, halo_variant=variant,
                                     spectral_variant="a2a")
        n0 = qgstep.launches
        st_b = run(shard_tree(st, mesh), shard_tree(f, mesh), n_steps)
        counts = {k: v / n_steps for k, v in mesh.counts.items()}
        full = gather_tree(st_b, mesh)
        out.append(dict(state={k: v.numpy() for k, v in
                               full._asdict().items()},
                        counts=counts, launches=qgstep.launches - n0,
                        pad_zero=padding_zero(st_b, mesh, cfg.nypo,
                                              cfg.nxpo)))
    return out if torch.distributed.get_rank() == 0 else None



def coupled_cfg(cfgmod, kind="box", dtype="float64", **over):
    """The small coupled configurations of the JAX tests, in `cfgmod`:
    'box' is the double gyre of tests/test_golden.py:67 and
    tests/test_coupling.py:15, 'channel' the miniature southern-ocean
    channel of tests/test_southern_ocean.py:22."""
    if kind == "box":
        return cfgmod.double_gyre_coupled(
            nxta=24, nyta=12, nxaooc=8, nyaooc=8, ndxr=4, dta=180.0,
            ocean=cfgmod.OceanConfig(dxo=20.0e3),
            dtype=dtype).replace(**over).validate()
    assert kind == "channel", kind
    return cfgmod.ModelConfig(
        nxta=24, nyta=18, nxaooc=24, nyaooc=6, ndxr=4,
        fnot=-1.19467e-4, beta=1.31301e-11, dta=180.0,
        ocean=cfgmod.OceanConfig(dxo=20.0e3), cyclic_ocean=True,
        nb_hflux=True, dtype=dtype).replace(**over).validate()


def seeded_coupled(kind, **over):
    """Model (CPU, float64) and a seeded coupled state (ocean, atmos): a
    noisy atmosphere over an eddying ocean with a noisy SST, so that
    every term of xforc is exercised, tau_udiff's ocean velocities
    included (the state of tests/test_torch_coupling.py)."""
    cfg = coupled_cfg(qgcm_torch.config, kind, **over)
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(1)
    pam = 500.0 * rng.standard_normal((cfg.nla, cfg.nypa, cfg.nxta))
    pam = np.concatenate([pam, pam[:, :, :1]], axis=2)
    at = init_atmos_state(model, pa=pam)

    def noise(t, amp):
        return t + amp * torch.from_numpy(rng.standard_normal(
            tuple(t.shape)))

    at = at._replace(astm=noise(at.astm, 1.0),
                     hmixam=noise(at.hmixam, 20.0))
    oc = init_ocean_state(model, init="rbal",
                          po=eddy_pressure(cfg, ssh_amp=0.3))
    return model, oc._replace(sstm=noise(oc.sstm, 1.0)), at


def numpy_fields(nt) -> dict:
    """{field: NumPy array} of a NamedTuple of tensors."""
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in nt._asdict().items()}


def block_padding_zero(v, mesh, ny, nx) -> bool:
    """Whether every row (and, on a mesh with x > 1, column) of this
    rank's block v at or beyond the grid's end (ny, nx) is zero."""
    rows = ny - mesh.iy * mesh.by
    ok = bool((v[..., max(0, rows):, :] == 0).all())
    if mesh.mx > 1:
        ok &= bool((v[..., max(0, nx - mesh.ix * mesh.bx):] == 0).all())
    return ok


def padding_zero(tree, mesh, nyp, nxp) -> bool:
    """Whether every row (and, on a mesh with x > 1, column) of this
    rank's blocks at or beyond the grid's end (nyp p rows, nyp - 1 T
    rows; nxp p columns, nxp - 1 T columns) is zero."""
    from qgcm_torch.state import T_COL_FIELDS, T_GRID_FIELDS
    ok = True
    for k, v in tree._asdict().items():
        if torch.is_tensor(v) and v.dim() >= 2:
            ok &= block_padding_zero(
                v, mesh, nyp - 1 if k in T_GRID_FIELDS else nyp,
                nxp - 1 if k in T_COL_FIELDS else nxp)
    return ok


def xforc_rank(cases, shape=None):
    """For each case (kind, config overrides): the decomposed xforc of
    the seeded coupled state on a rows mesh of the ranks (or a mesh of
    `shape`), the atmosphere in its row blocks: the ocean and the
    atmospheric forcing gathered whole, the diagnostics and the
    replicated scalars of the atmospheric forcing (the same bits on every
    rank), the collective counts and whether the forcings' padding is
    zero."""
    from qgcm_torch.coupling import make_xforc
    from qgcm_torch.parallel.mesh import atmos_mesh
    torch.set_num_threads(1)
    out = []
    for kind, over in cases:
        model, oc, at = seeded_coupled(kind, **over)
        cfg = model.cfg
        mesh = _grid_mesh(shape, (cfg.nypo, cfg.nxpo))
        amesh = atmos_mesh(mesh, cfg)
        ob, ab = shard_tree(oc, mesh), shard_tree(at, amesh)
        ofor, afor, xd = make_xforc(model, mesh=mesh)(
            ab.pam, ob.pom, ob.sstm, ab.astm, ab.hmixam)
        counts = dict(mesh.counts)
        out.append(dict(ofor=numpy_fields(gather_tree(ofor, mesh)),
                        afor=numpy_fields(gather_tree(afor, amesh)),
                        diags=numpy_fields(xd),
                        scalars=[afor.txisat.numpy(), afor.txinat.numpy()],
                        counts=counts,
                        pad_zero=padding_zero(ofor, mesh, cfg.nypo, cfg.nxpo)
                        and padding_zero(afor, amesh, cfg.nypa, cfg.nxpa)))
    return out


def coupled_runner_rank(cases, shape=None):
    """For each case (kind, config overrides, halo variant, cycles): the
    seeded coupled state run that many coupling cycles by the decomposed
    coupled runner on a rows mesh of the ranks (or a mesh of `shape`),
    the atmosphere in its row blocks: both fluids gathered whole, this
    rank's replicated leaves of the atmosphere (the same bits on every
    rank), the collectives per cycle, qgstep's launches and whether the
    padding stayed zero."""
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep
    from qgcm_torch.parallel.mesh import atmos_mesh, replicated
    torch.set_num_threads(1)
    out = []
    for kind, over, variant, cycles in cases:
        model, oc, at = seeded_coupled(kind, **over)
        cfg = model.cfg
        mesh = _grid_mesh(shape, (cfg.nypo, cfg.nxpo))
        amesh = atmos_mesh(mesh, cfg)
        run = make_coupled_runner(model, mesh=mesh, halo_variant=variant,
                                  spectral_variant="a2a")
        n0 = qgstep.launches
        ob, ab = run(shard_tree(oc, mesh), shard_tree(at, amesh),
                     cycles * cfg.nstr)
        counts = {k: v / cycles for k, v in mesh.counts.items()}
        out.append(dict(ocean=numpy_fields(gather_tree(ob, mesh)),
                        atmos=numpy_fields(gather_tree(ab, amesh)),
                        replicated={k: v.numpy() for k, v in
                                    ab._asdict().items() if replicated(v)},
                        counts=counts,
                        launches=qgstep.launches - n0,
                        pad_zero=padding_zero(ob, mesh, cfg.nypo, cfg.nxpo)
                        and padding_zero(ab, amesh, cfg.nypa, cfg.nxpa)))
    return out


def mesh_specs(specs, cyclic=False):
    """For each --mesh spec: the (my, mx) of the mesh it makes on the
    ranks (for a 33 x 33 grid), or the type and message of what it
    raised."""
    from qgcm_torch.parallel.mesh import mesh_from_spec
    out = []
    for spec in specs:
        try:
            m = mesh_from_spec(spec, cyclic, (33, 33))
            out.append((m.my, m.mx))
        except (NotImplementedError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def coupled_rank(xforc_cases, runner_cases, specs, shape=None):
    """xforc_rank, coupled_runner_rank (on a rows mesh, or a mesh of
    `shape`) and mesh_specs (box, then channel) in one spawn."""
    return dict(xforc=xforc_rank(xforc_cases, shape),
                runner=coupled_runner_rank(runner_cases, shape),
                specs=(mesh_specs(specs), mesh_specs(specs, cyclic=True)))


def float64_files(mp, pkg, declared):
    """Make every writer of the package `pkg` ('qgcm_torch', or in a test
    process 'qgcm_tpu') store float64 where it declares float32 ('f'),
    and record the declared types in `declared`, while the MonkeyPatch
    `mp` lasts: a comparison then sees the full values, and the types
    are compared separately."""
    nc = importlib.import_module(pkg + ".io.ncdf")

    class Writer(nc.NcWriter):
        def var(self, name, dtype, dims, **kw):
            declared[(os.path.basename(self.f.filename), name)] = dtype
            return super().var(name, "d" if dtype == "f" else dtype, dims,
                               **kw)

    def make(path, backend=None):
        return Writer(path)

    mp.setattr(nc, "make_writer", make)
    for mod in ("snapshots", "restart", "forcing"):
        mp.setattr(importlib.import_module(f"{pkg}.io.{mod}"), "NcWriter",
                   make)


def driver_rank(runs, argvs, fail_rank=None, shape=None):
    """What each rank of tests/test_torch_parallel_driver.py runs, with
    float64 files: `runs`, each (config, RunParams, outdir, Driver
    keywords) through the port's Driver on a rows mesh of the ranks, or
    on a mesh of `shape` (returning steps done, whether it aborted and
    the collective counts); then `argvs` through qgcm_torch.cli.main
    (returning the exit code, or the message of a SystemExit, and what
    the rank printed).
    On rank `fail_rank` valids fails, as a blow-up seen by one rank
    alone would."""
    import contextlib
    import io
    import pytest
    import qgcm_torch.run
    from qgcm_torch.cli import main
    from qgcm_torch.run import Driver
    torch.set_num_threads(1)
    out = dict(runs=[], cli=[])
    with pytest.MonkeyPatch.context() as mp:
        float64_files(mp, "qgcm_torch", {})
        if fail_rank == torch.distributed.get_rank():
            real = qgcm_torch.run.valids

            def failing(*a, **kw):
                return real(*a, **kw)._replace(ok=torch.tensor(False))

            mp.setattr(qgcm_torch.run, "valids", failing)
        for cfg, params, outdir, kw in runs:
            model = build_model(cfg, "cpu")
            mesh = _grid_mesh(shape, (cfg.nypo, cfg.nxpo))
            res = Driver(model, params, outdir, mesh=mesh, verbose=False,
                         **kw).run()
            out["runs"].append(dict(steps=res.steps_done,
                                    aborted=res.aborted,
                                    counts=dict(mesh.counts)))
        for argv in argvs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    code = main(argv)
                except SystemExit as e:
                    code = str(e.code)
            out["cli"].append((code, buf.getvalue()))
    return out


def raising_rank(n_steps):
    """Rank 1 raises after the ranks' first collective, while the others
    go on into the next one."""
    mesh = make_mesh(rows_only=True)
    mesh.all_reduce(torch.ones(1), "test")
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("this rank fails")
    for _ in range(n_steps):
        mesh.all_reduce(torch.ones(1), "test")


def adjoint_setup(kind):
    """(model, state, mean forcing, objective) of a distributed-adjoint
    case on the CPU in float64: the seeded state of small_cfg, the box
    ('box') or the channel ('channel'), under the double-gyre wind, with
    layer1_energy_proxy in the box and transport_proxy in the
    channel."""
    from qgcm_torch.adjoint import layer1_energy_proxy, transport_proxy
    model, st, f = seeded_state(small_cfg(kind == "channel"))
    obj = (transport_proxy if kind == "channel" else layer1_energy_proxy)
    return model, st, (f.tauxo, f.tauyo, f.fnetoc), obj(model)


def adjoint_rank(cases, steps, halo_cases=(), pair_cases=(),
                 coupled_cases=(), cycles=2):
    """For each case (kind of adjoint_setup, mesh shape: 'rows' or (my,
    mx), halo variant, remat, segment_steps): ocean_sensitivity on a mesh
    of the ranks over `steps` substeps. Every rank returns the value and
    the forcing gradients (which must be the same bits on every rank),
    whether its state0 gradient's padding is zero, the collective counts
    by site and qgstep's launches by mode; rank 0 adds the state0
    gradient gathered whole. Then halo_grad_rank's `halo_cases`, the
    `pair_cases` on a rows mesh of a group of ranks 0 and 1 (the others
    wait), and coupled_grad_rank's `coupled_cases` over `cycles`
    coupling cycles."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = dict(adjoint=_adjoint_cases(cases, steps),
               halo=halo_grad_rank(halo_cases),
               coupled=coupled_grad_rank(coupled_cases, cycles))
    if pair_cases:
        pair = dist.new_group([0, 1])
        if dist.get_rank() < 2:
            out["pair"] = _adjoint_cases(pair_cases, steps, pair)
    return out


def _adjoint_cases(cases, steps, group=None):
    from qgcm_torch.adjoint import ocean_sensitivity
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    out = []
    for kind, shape, variant, remat, seg in cases:
        model, st, mf, obj = adjoint_setup(kind)
        cfg = model.cfg
        mesh = (_grid_mesh(shape, (cfg.nypo, cfg.nxpo)) if group is None
                else Mesh((2, 1), grid=(cfg.nypo, cfg.nxpo), group=group))
        reset_launches()
        val, g = ocean_sensitivity(model, obj, remat=remat,
                                   segment_steps=seg, mesh=mesh,
                                   halo_variant=variant)(
            shard_tree(st, mesh), mf, steps)
        res = dict(value=float(val), forcing=[a.numpy() for a in g.forcing],
                   pad_zero=padding_zero(g.state0, mesh, cfg.nypo, cfg.nxpo),
                   counts=dict(mesh.counts),
                   launches=dict(qgstep.mode_launches))
        full = numpy_fields(gather_tree(g.state0, mesh))
        if mesh.rank == 0:
            res["state0"] = full
        out.append(res)
    return out


def halo_grad_rank(cases):
    """For each case (cyclic, sponge, mesh shape, variant, nyaooc): the
    gradient of sum(qgstep_halo(blocks) * weights) with respect to every
    block input, gathered whole (rank 0), and the collective counts: the
    schedules' exchanges, gathers and window launches under autograd."""
    from qgcm_torch.parallel.halo import qgstep_halo
    out = []
    for cyclic, sponge, shape, variant, nyaooc in cases:
        cfg = small_cfg(cyclic, sponge, nyaooc=nyaooc)
        args = halo_args(cfg)
        mesh = _grid_mesh(shape, (cfg.nypo, cfg.nxpo))
        blocks = [None if a is None else
                  shard(a, mesh).requires_grad_() for a in args[:7]]
        w = shard(halo_weights(cfg), mesh)
        q = qgstep_halo(*blocks, *args[7:], cyclic=cyclic, sponge=sponge,
                        mesh=mesh, variant=variant)
        grads = torch.autograd.grad((q * w).sum(),
                                    [b for b in blocks if b is not None])
        full = [gather(g, mesh, site="test").numpy() for g in grads]
        out.append(dict(grads=full, counts=dict(mesh.counts)))
    return out if torch.distributed.get_rank() == 0 else None


def halo_weights(cfg):
    """Seeded weights of the output of a vorticity step."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.standard_normal((cfg.nlo, cfg.nypo,
                                                 cfg.nxpo)))


def coupled_loss(model):
    """The coupled adjoint's objective of a final (ocean, atmosphere):
    qgcm_tpu's, mean(ast^2) of the atmosphere (tests/test_adjoint.py:
    157-190), plus the ocean's layer1_energy_proxy."""
    from qgcm_torch.adjoint import layer1_energy_proxy
    proxy = layer1_energy_proxy(model)

    def loss(ocean, atmos):
        return torch.mean(torch.square(atmos.ast)) + proxy(ocean)

    return loss


def coupled_gradient(model, run, ocean, atmos, n_steps, mesh=None):
    """(value, d/d ocean0, d/d atmos0) of coupled_loss after n_steps of
    the coupled runner `run`, every field of both initial states a leaf.
    With `mesh` the states are this rank's blocks (the atmosphere on
    atmos_mesh) and run a mesh runner: the final states are gathered,
    the loss seeded on rank 0 alone, the replicated leaves' gradients
    summed over the ranks by one all_reduce and the blocks' padding
    zero (adjoint.ocean_sensitivity's conventions)."""
    from qgcm_torch.adjoint import _grads, _leaves
    from qgcm_torch.parallel.mesh import atmos_mesh, replicated, \
        zero_padding
    from qgcm_torch.state import AtmosState, OceanState
    lo, la = OceanState(*_leaves(ocean)), AtmosState(*_leaves(atmos))
    with torch.enable_grad():
        o, a = run(lo, la, n_steps)
        seed = None
        if mesh is not None:
            amesh = atmos_mesh(mesh, model.cfg)
            o, a = gather_tree(o, mesh), gather_tree(a, amesh)
        val = coupled_loss(model)(o, a)
        if mesh is not None:
            seed = [torch.ones_like(val) if mesh.rank == 0
                    else torch.zeros_like(val)]
        g = _grads([val], [*lo, *la], seed)
    go, ga = OceanState(*g[:len(lo)]), AtmosState(*g[len(lo):])
    if mesh is not None:
        rep = [(t, k) for t in (go, ga) for k, v in t._asdict().items()
               if replicated(v)]
        parts = [getattr(t, k) for t, k in rep]
        tot = mesh.all_reduce(torch.cat([p.reshape(-1) for p in parts]),
                              "test.sums")
        sums = iter(v.view_as(p) for v, p in zip(
            tot.split([p.numel() for p in parts]), parts))
        go = zero_padding(go._replace(**{k: next(sums) for t, k in rep
                                         if t is go}), mesh)
        ga = zero_padding(ga._replace(**{k: next(sums) for t, k in rep
                                         if t is ga}), amesh)
    return val.detach(), go, ga


def coupled_grad_rank(cases, cycles):
    """For each case (kind, config overrides, mesh shape, halo variant,
    remat): coupled_gradient through the coupled mesh runner on a mesh of
    the ranks over `cycles` coupling cycles. Every rank returns the
    value, its replicated gradients, whether its blocks' padding is zero,
    its collective counts by site and qgstep's launches; rank 0 adds the
    gradients gathered whole."""
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    from qgcm_torch.parallel.mesh import atmos_mesh, replicated
    out = []
    for kind, over, shape, variant, remat in cases:
        model, oc, at = seeded_coupled(kind, **over)
        cfg = model.cfg
        mesh = _grid_mesh(shape, (cfg.nypo, cfg.nxpo))
        amesh = atmos_mesh(mesh, cfg)
        run = make_coupled_runner(model, remat=remat, mesh=mesh,
                                  halo_variant=variant,
                                  spectral_variant="a2a")
        reset_launches()
        val, go, ga = coupled_gradient(
            model, run, shard_tree(oc, mesh), shard_tree(at, amesh),
            cycles * cfg.nstr, mesh)
        res = dict(value=float(val), counts=dict(mesh.counts),
                   launches=dict(qgstep.mode_launches),
                   replicated={f"{n}.{k}": v.numpy() for n, t in
                               (("ocean", go), ("atmos", ga))
                               for k, v in t._asdict().items()
                               if replicated(v)},
                   sst_rows=bool((go.sst + go.sstm)[:max(0, min(
                       mesh.by, cfg.nyto - mesh.iy * mesh.by))].abs()
                       .max() > 0),
                   pad_zero=padding_zero(go, mesh, cfg.nypo, cfg.nxpo)
                   and padding_zero(ga, amesh, cfg.nypa, cfg.nxpa))
        whole = (numpy_fields(gather_tree(go, mesh)),
                 numpy_fields(gather_tree(ga, amesh)))
        if mesh.rank == 0:
            res["ocean"], res["atmos"] = whole
        out.append(res)
    return out
