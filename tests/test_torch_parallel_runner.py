"""qgcm_torch.parallel: the decomposed ocean-only runner, in float64 on
the CPU in real gloo ranks (rows meshes of 2 and 4 ranks, and the box on
2x2 and 1x4 meshes), against qgcm_tpu's make_ocean_only_runner(mesh,
halo_variant, 'a2a') over 20 substeps on a mesh of the same shape, at
1e-11 of each field's maximum (the bar of tests/test_sharding.py:41-58);
and what the runner refuses, what it counts, and that the port's
parallel modules load no JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import _torch_ranks as ranks
from qgcm_torch.models.ocean import make_ocean_step
from qgcm_torch.models.stepper import make_ocean_only_runner
from qgcm_torch.parallel.launch import (distributed_session, is_primary,
                                        spawn_ranks)
from qgcm_torch.parallel.mesh import gather_tree, make_mesh, shard_tree

from test_torch_cases import one_torch_thread, rel_err

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-11
STEPS = 20
# (cyclic, variant, n_steps, nyaooc) run by every rank count; nyaooc 6
# gives 13 rows, where 4 ranks leave the last with the north wall row
# alone (its inner neighbour comes from the block below)
CASES = [(False, "overlap", STEPS, 12), (True, "overlap", STEPS, 12),
         (False, "deep", 2, 6), (True, "staged", 2, 6)]
RANKS = (2, 4)
FIELDS = {False: ("po", "qo", "sst", "dpioc"),
          True: ("po", "qo", "sst", "dpioc", "ocncs", "ocncn")}


# the box on 2-D meshes: (cyclic, variant, n_steps, nyaooc, nxaooc). The
# 25 x 49 grid leaves ragged last row and column blocks on both meshes;
# the 13 x 13 grid on 1x4 leaves the last column block with the east wall
# column alone (its inner neighbour comes from the block west of it)
CASES_2D = [(False, "overlap", STEPS, 12, 24), (False, "deep", 2, 6, 6)]
IDS_2D = ["overlap-25x49", "deep-13x13"]
MESHES = ((2, 2), (1, 4))
MESH_IDS = ["2x2", "1x4"]
# the GEMM DST (solver_transform='matmul', its split forced active in the
# ranks by _torch_ranks.matmul_cfg) in the same spawns, after the cases
# above: the box and the channel on the rows meshes, the box on the 2-D
# ones
CASES_MM = [(False, "overlap", STEPS, 12, 24, "matmul"),
            (True, "overlap", STEPS, 12, 24, "matmul")]
CASES_2D_MM = [(False, "overlap", STEPS, 12, 24, "matmul")]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = {n: spawn_ranks(ranks.runner_rank, n, CASES + CASES_MM,
                          backend="gloo",
                          workdir=tmp_path_factory.mktemp(f"run{n}"),
                          timeout=120)[0]
           for n in RANKS}
    for my, mx in MESHES:
        out[(my, mx)] = spawn_ranks(
            ranks.runner_rank, my * mx, CASES_2D + CASES_2D_MM, (my, mx),
            backend="gloo",
            workdir=tmp_path_factory.mktemp(f"run{my}x{mx}"),
            timeout=120)[0]
    return out


def _jax_run(cyclic, nyaooc, n, variant, steps, nxaooc=24):
    """qgcm_tpu's mesh runner on n x 1 devices, or on a mesh of n = (my,
    mx), from the seeded state."""
    import qgcm_tpu.config
    from test_torch_cases import to_jax
    from qgcm_tpu.model import build_model as jax_build
    from qgcm_tpu.models.stepper import make_ocean_only_runner as jax_runner
    from qgcm_tpu.parallel.mesh import shard_tree as jax_shard
    from qgcm_tpu.state import OceanForcing, OceanState
    cfg = ranks.small_cfg(cyclic, nyaooc=nyaooc, nxaooc=nxaooc,
                          cfgmod=qgcm_tpu.config)
    jm = jax_build(cfg.replace(solver_transform="fft"))
    _, st, f = ranks.seeded_state(ranks.small_cfg(cyclic, nyaooc=nyaooc,
                                                  nxaooc=nxaooc))
    my, mx = n if isinstance(n, tuple) else (n, 1)
    mesh = JaxMesh(np.asarray(jax.devices()[:my * mx]).reshape(my, mx),
                   ("y", "x"))
    run = jax_runner(jm, mesh=mesh, halo_variant=variant,
                     spectral_variant="a2a")
    out = run(jax_shard(to_jax(OceanState, st), mesh),
              jax_shard(to_jax(OceanForcing, f), mesh), steps)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("cyclic", [False, True], ids=["box", "channel"])
def test_runner_matches_qgcm_tpu_mesh_runner(spawned, cyclic, n):
    """20 substeps of the overlap + a2a runner on n rows ranks against
    qgcm_tpu's mesh runner on n devices: each field within 1e-11 of its
    maximum; 20 kernel-path launches of the plain chain: none."""
    res = spawned[n][0 if not cyclic else 1]
    want = _jax_run(cyclic, 12, n, "overlap", STEPS)
    for name in FIELDS[cyclic]:
        assert rel_err(res["state"][name], want[name]) <= TOL, name
    assert res["pad_zero"]
    assert res["launches"] == 0        # CPU tensors: the plain chains


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", [2, 3], ids=["box-deep", "channel-staged"])
def test_runner_short_schedules_match_single_device(spawned, case, n):
    """'deep' and 'staged' for 2 substeps on 13 rows (the north wall row
    alone in the last block at 4 ranks) against the port's single-device
    runner at 1e-11 of each field's maximum."""
    cyclic, variant, steps, nyaooc = CASES[case]
    model, st, f = ranks.seeded_state(ranks.small_cfg(cyclic,
                                                      nyaooc=nyaooc))
    ref = make_ocean_only_runner(model)(st, f, steps)
    res = spawned[n][case]
    for name in FIELDS[cyclic]:
        assert rel_err(res["state"][name], getattr(ref, name)) <= TOL, name
    assert res["pad_zero"]


# (spawn, case of CASES_MM): each rows mesh runs both, each 2-D mesh the
# box
MM_WHERE = [*((n, c) for n in RANKS for c in range(len(CASES_MM))),
            *((m, 0) for m in MESHES)]
MM_IDS = [("%dx%d" % (w if isinstance(w, tuple) else (w, 1)))
          + ("-channel" if CASES_MM[c][0] else "-box") for w, c in MM_WHERE]


@pytest.mark.parametrize("where,case", MM_WHERE, ids=MM_IDS)
def test_matmul_runner_matches_single_device(spawned, where, case,
                                             monkeypatch):
    """20 'overlap' substeps under solver_transform='matmul' on rows
    meshes of 2 and 4 ranks (box and channel) and on 2x2 and 1x4 (box):
    each field within 1e-11 of its maximum of the port's single-device
    'matmul' runner (which tests/test_torch_dst_matmul.py holds to
    qgcm_tpu's), padding zero, no kernel launch on CPU tensors."""
    import qgcm_torch.solver.helmholtz as helmholtz
    monkeypatch.setattr(helmholtz, "_MM_SPLIT_MIN", 4)
    cyclic, variant, steps, nyaooc, nxaooc, _ = CASES_MM[case]
    cfg = ranks.small_cfg(cyclic, nyaooc=nyaooc, nxaooc=nxaooc)
    model, st, f = ranks.seeded_state(cfg.replace(solver_transform="matmul"))
    assert model.inv_oc.helm.ty.levels
    ref = make_ocean_only_runner(model)(st, f, steps)
    offset = len(CASES) if isinstance(where, int) else len(CASES_2D)
    res = spawned[where][offset + case]
    for name in FIELDS[cyclic]:
        assert rel_err(res["state"][name], getattr(ref, name)) <= TOL, name
    assert res["pad_zero"]
    assert res["launches"] == 0


# collectives per substep: the mixed layer's two exchanges (sst, sstm,
# po, tau; the entrainment), its two sums, the vorticity step's
# schedule, the channel's wall strips, the inversion's transposes (2 box,
# 4 channel) and its sums, and ocqbdy's exchange where the north wall
# row starts a block
COUNTS = {
    (False, "overlap", 12): {"ocean.oml.rows": 4, "ocean.oml.sums": 2,
                             "halo.rows": 2, "spectral.a2a": 2,
                             "ocean.inversion.sums": 1},
    (True, "overlap", 12): {"ocean.oml.rows": 4, "ocean.oml.sums": 2,
                            "halo.rows": 2, "ocean.walls": 1,
                            "spectral.a2a": 4, "ocean.inversion.sums": 1},
    (False, "deep", 6): {"ocean.oml.rows": 4, "ocean.oml.sums": 2,
                         "halo.rows": 2, "spectral.a2a": 2,
                         "ocean.inversion.sums": 1},
    (True, "staged", 6): {"ocean.oml.rows": 4, "ocean.oml.sums": 2,
                          "halo.rows": 6, "ocean.walls": 1,
                          "spectral.a2a": 4, "ocean.inversion.sums": 1},
}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{'channel' if c else 'box'}-{v}-{y}"
                              for c, v, _, y in CASES])
def test_runner_collectives_per_substep(spawned, case, n):
    """The collectives of a substep are pinned by schedule, as
    tests/test_halo.py:118,212 pin XLA's."""
    cyclic, variant, _, nyaooc = CASES[case]
    want = dict(COUNTS[(cyclic, variant, nyaooc)])
    nyp = 2 * nyaooc + 1
    by = -(-nyp // n)
    if (nyp - 1) % by == 0:
        want["ocean.ocqbdy.rows"] = 2
    got = {k: v for k, v in spawned[n][case]["counts"].items()
           if k != "gather"}
    assert got == want


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", range(len(CASES_2D)), ids=IDS_2D)
def test_2d_runner_matches_qgcm_tpu_mesh_runner(spawned, case, mesh):
    """The box on a 2-D mesh: 20 'overlap' substeps (25 x 49) and 2
    'deep' ones (13 x 13, the east wall column alone in a block on 1x4)
    against qgcm_tpu's mesh runner on a mesh of the same shape, each
    field within 1e-11 of its maximum; the padding rows and columns stay
    zero; no launch of the kernel path on CPU tensors."""
    cyclic, variant, steps, nyaooc, nxaooc = CASES_2D[case]
    res = spawned[mesh][case]
    want = _jax_run(cyclic, nyaooc, mesh, variant, steps, nxaooc)
    for name in FIELDS[cyclic]:
        assert rel_err(res["state"][name], want[name]) <= TOL, name
    assert res["pad_zero"]
    assert res["launches"] == 0


# collectives per substep on a 2-D mesh: the rows of COUNTS, each
# exchange of ghost rows followed by one of ghost columns (the mixed
# layer's two, the vorticity step's), the box's four transposes, and
# ocqbdy's column exchange where the east wall column starts a block
COUNTS_2D = {"ocean.oml.rows": 4, "ocean.oml.cols": 4, "ocean.oml.sums": 2,
             "halo.rows": 2, "halo.cols": 2, "spectral.a2a": 4,
             "ocean.inversion.sums": 1}


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", range(len(CASES_2D)), ids=IDS_2D)
def test_2d_runner_collectives_per_substep(spawned, case, mesh):
    """The 2-D substep's collectives, pinned as the rows ones are."""
    _, _, _, nyaooc, nxaooc = CASES_2D[case]
    nyp, nxp = 2 * nyaooc + 1, 2 * nxaooc + 1
    by, bx = -(-nyp // mesh[0]), -(-nxp // mesh[1])
    want = dict(COUNTS_2D)
    if (nyp - 1) % by == 0:
        want["ocean.ocqbdy.rows"] = 2
    if (nxp - 1) % bx == 0:
        want["ocean.ocqbdy.cols"] = 2
    got = {k: v for k, v in spawned[mesh][case]["counts"].items()
           if k != "gather"}
    assert got == want


def test_mesh_run_refuses_gspmd_choices():
    """What qgcm_tpu leaves to GSPMD's partitioning on a mesh
    (halo_variant None, spectral_variant None) the port runs as
    'overlap' and 'a2a': on a one-rank mesh the same bits as with those
    variants named; a spectral variant the port does not know raises. A
    bare sharded step (no halo pair) is the single-device step. Without
    a mesh the variants are not read."""
    cfg = ranks.small_cfg()
    model, st, f = ranks.seeded_state(cfg)
    mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
    blocks = shard_tree(st, mesh), shard_tree(f, mesh)
    want = make_ocean_only_runner(model, mesh=mesh, halo_variant="overlap",
                                  spectral_variant="a2a")(*blocks, 1)
    for kw in (dict(halo_variant=None, spectral_variant="a2a"),
               dict(halo_variant="overlap", spectral_variant=None), {}):
        got = make_ocean_only_runner(model, mesh=mesh, **kw)(*blocks, 1)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kw
    with pytest.raises(ValueError, match="unknown spectral_variant"):
        make_ocean_only_runner(model, mesh=mesh, halo_variant="overlap",
                               spectral_variant="gspmd")
    bare, single = (make_ocean_step(model, sharded=s)(st, f)[0]
                    for s in (True, False))
    assert all(torch.equal(a, b) for a, b in zip(bare, single))
    out = make_ocean_only_runner(model, halo_variant="deep")(st, f, 1)
    ref = make_ocean_only_runner(model)(st, f, 1)
    assert torch.equal(out.po, ref.po)


@pytest.mark.parametrize("cyclic", [False, True], ids=["box", "channel"])
def test_one_rank_mesh_runner_matches_single_device(cyclic):
    """Without a process group a mesh is one rank: the decomposed runner
    on one block of the whole grid against the single-device runner,
    25 substeps (one averaging)."""
    cfg = ranks.small_cfg(cyclic)
    model, st, f = ranks.seeded_state(cfg)
    mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
    run = make_ocean_only_runner(model, mesh=mesh, halo_variant="overlap",
                                 spectral_variant="a2a")
    got = gather_tree(run(shard_tree(st, mesh), shard_tree(f, mesh), 25),
                      mesh)
    ref = make_ocean_only_runner(model)(st, f, 25)
    for name in FIELDS[cyclic]:
        assert rel_err(getattr(got, name), getattr(ref, name)) <= TOL, name


def test_mesh_refusals():
    """The decomposed step takes a mesh of the model's grid, with blocks
    of 3 rows (and columns) at least, of as many ranks as the group has;
    a channel's mesh has x = 1 (the duplicated column's wraparound,
    qgcm_tpu's reason)."""
    from types import SimpleNamespace
    from qgcm_torch.parallel.mesh import Mesh
    cfg = ranks.small_cfg()
    model, _, _ = ranks.seeded_state(cfg)
    with pytest.raises(ValueError, match="grid"):
        make_ocean_step(model, halo=(make_mesh(grid=(9, 9)), "deep"))
    with pytest.raises(ValueError, match="ranks"):
        Mesh((2, 1), grid=(cfg.nypo, cfg.nxpo))
    with pytest.raises(ValueError, match="ranks"):
        Mesh((2, 2), grid=(cfg.nypo, cfg.nxpo))
    channel = ranks.small_cfg(cyclic=True)
    model_c, _, _ = ranks.seeded_state(channel)
    fake = SimpleNamespace(grid=(channel.nypo, channel.nxpo), my=1, mx=2,
                           by=channel.nypo, bx=channel.nxpo // 2 + 1)
    with pytest.raises(ValueError, match="duplicated east column"):
        make_ocean_step(model_c, halo=(fake, "overlap"))
    thin = SimpleNamespace(grid=(cfg.nypo, cfg.nxpo), my=1, mx=25, by=cfg.nypo,
                           bx=2)
    with pytest.raises(ValueError, match="too thin"):
        make_ocean_step(model, halo=(thin, "overlap"))


def test_launch_without_a_process_group():
    """distributed_session is a no-op in one process outside torchrun's
    environment, and that process is the primary; spawn_ranks refuses a
    used rendezvous directory."""
    with distributed_session():
        assert is_primary()
        assert not torch.distributed.is_initialized()


def test_distributed_session_under_torchrun(tmp_path):
    """Under torchrun the rank and size come from its environment: two
    gloo ranks started by torch.distributed.run sum their ranks."""
    script = tmp_path / "ranks.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import torch, torch.distributed as dist\n"
        "from qgcm_torch.parallel.launch import distributed_session\n"
        "from qgcm_torch.parallel.mesh import make_mesh\n"
        "with distributed_session('gloo'):\n"
        "    mesh = make_mesh(rows_only=True)\n"
        "    tot = mesh.all_reduce(torch.tensor([float(mesh.rank)]), 't')\n"
        "    print(f'rank {mesh.rank} of {mesh.size}: {tot.item()}')\n")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script)], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "rank 0 of 2: 1.0" in res.stdout
    assert "rank 1 of 2: 1.0" in res.stdout


def test_spawn_refuses_a_used_rendezvous(tmp_path):
    (tmp_path / "rendezvous").write_text("")
    with pytest.raises(FileExistsError):
        spawn_ranks(ranks.runner_rank, 2, [], backend="gloo",
                    workdir=tmp_path)


def test_parallel_modules_import_no_jax():
    """The port's parallel modules, the modules the decomposed coupled
    model, Driver and commands run in the ranks, and the ranks' module
    load no JAX and no qgcm_tpu (the spawned ranks import only these)."""
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import qgcm_torch.parallel.launch, qgcm_torch.parallel.mesh\n"
            "import qgcm_torch.parallel.halo, qgcm_torch.parallel.spectral\n"
            "import qgcm_torch.coupling, qgcm_torch.models.stepper\n"
            "import qgcm_torch.models.ensemble, qgcm_torch.run\n"
            "import qgcm_torch.cli, qgcm_torch.diags.timavge\n"
            "import qgcm_torch.models.ocean, qgcm_torch.ops.integrals\n"
            "import qgcm_torch.ops.vorticity, qgcm_torch.state\n"
            "import _torch_ranks\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'qgcm_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
