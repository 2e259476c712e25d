"""What each rank runs in the multi-process tests of qgcm_torch.parallel
(tests/test_torch_parallel_*.py), and the inputs both those ranks and
the tests build. The ranks are started with the "spawn" method
(qgcm_torch.parallel.launch.spawn_ranks), so this module imports only
torch, numpy and qgcm_torch: never JAX, never qgcm_tpu."""

import numpy as np
import torch

import qgcm_torch.config
from qgcm_torch.generators import double_gyre_windstress, eddy_pressure
from qgcm_torch.model import build_model
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
    if shape == "rows":
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


def solver_rank(cases):
    """For each case (kind, nyp, nxp, ytransform, seed): the row-blocked
    sharded solve gathered whole, and for the box the spectrum (its
    column chunks gathered) with its padded columns."""
    from qgcm_torch.parallel.spectral import (ShardedBoxHelmholtz,
                                              ShardedCyclicHelmholtz)
    torch.set_num_threads(1)
    out = []
    for kind, nyp, nxp, ytransform, seed in cases:
        base = base_solver(kind, nyp, nxp, ytransform)
        mesh = make_mesh(rows_only=True, grid=(nyp, nxp))
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
                   pad_zero=bool((sol[:, max(0, nyp - mesh.iy * mesh.by):]
                                  == 0).all()),
                   a2a=mesh.counts["spectral.a2a"])
        if spec is not None:
            res["spec"] = spec.numpy()
        out.append(res)
    return out if torch.distributed.get_rank() == 0 else None


def runner_rank(cases):
    """For each case (cyclic, variant, n_steps, nyaooc): the seeded state
    run n_steps substeps by the sharded runner, gathered whole, with the
    collective counts per substep and qgstep's launches."""
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep
    torch.set_num_threads(1)
    out = []
    for cyclic, variant, n_steps, nyaooc in cases:
        cfg = small_cfg(cyclic, nyaooc=nyaooc)
        model, st, f = seeded_state(cfg)
        mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
        run = make_ocean_only_runner(model, mesh=mesh, halo_variant=variant,
                                     spectral_variant="a2a")
        n0 = qgstep.launches
        st_b = run(shard_tree(st, mesh), shard_tree(f, mesh), n_steps)
        counts = {k: v / n_steps for k, v in mesh.counts.items()}
        full = gather_tree(st_b, mesh)
        out.append(dict(state={k: v.numpy() for k, v in
                               full._asdict().items()},
                        counts=counts, launches=qgstep.launches - n0,
                        pad_zero=all(bool((getattr(st_b, k)[
                            ..., max(0, cfg.nypo - mesh.iy * mesh.by):, :]
                            == 0).all()) for k in ("po", "qo", "pom", "qom"))))
    return out if torch.distributed.get_rank() == 0 else None

