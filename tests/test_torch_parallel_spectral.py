"""qgcm_torch.parallel.spectral: the Helmholtz solves on row blocks and
on 2-D blocks by all_to_all pencil transposes, in float64 on the CPU in
real gloo ranks (2x1 and 4x1 rows meshes; 2x2, 1x4 and 1x2 meshes),
against the port's single-device solvers at 1e-13 of the solution's
maximum on rows meshes (the bar of tests/test_spectral.py:46-56) and
1e-12 on 2-D meshes, and against qgcm_tpu's sharded solvers on meshes of
the same shape at 1e-12 (the bar the single-device solvers meet against
qgcm_tpu, tests/test_torch_helmholtz.py:40); box and channel, even and
uneven shapes, among them the aspects of tests/test_spectral.py:222,
252."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import _torch_ranks as ranks
from qgcm_torch.parallel.launch import spawn_ranks
from qgcm_torch.parallel.mesh import make_mesh
from qgcm_torch.parallel.spectral import (ShardedBoxHelmholtz,
                                          ShardedCyclicHelmholtz,
                                          wrap_inversions)

from test_torch_cases import one_torch_thread, rel_err

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

# (kind, nyp, nxp, transform, seed): tests/test_spectral.py's 15 x 19
# box and 15 x 17 channel (uneven over 2 and 4 rows), an even box, the
# channel's GEMM y-DST, and the uneven realistic aspects of
# test_spectral.py:222 (577^2 box) and :252 (145 x 1153 channel); then
# the GEMM DST where it splits (575 = 2 * 288 - 1 and 479 = 2 * 240 - 1
# interior points, one level above _MM_SPLIT_MIN): the 577^2 box and a
# channel of 481 rows, whose spectra are in packed order; and the
# channel's 'sine' y-DST, one GEMM with the dense sine matrix (the one
# 'auto' builds for a float32 channel of 512 rows or more; qgcm_tpu's
# 'matmul' at this height)
CASES = [("box", 15, 19, "fft", 0), ("cyclic", 15, 17, "fft", 1),
         ("box", 16, 12, "fft", 2), ("cyclic", 15, 17, "matmul", 3),
         ("box", 577, 577, "fft", 4), ("cyclic", 145, 1153, "fft", 5),
         ("box", 577, 577, "matmul", 6), ("cyclic", 481, 33, "matmul", 7),
         ("cyclic", 15, 17, "sine", 8)]
IDS = [f"{k}-{ny}x{nx}-{t}" for k, ny, nx, t, _ in CASES]
RANKS = (2, 4)
# the 2-D meshes (my, mx) of tests/test_spectral.py:36's kind, on 4 and 2
# ranks; TOL_2D is their bar against either reference (the bar the
# single-device solvers meet against qgcm_tpu)
MESHES = ((2, 2), (1, 4), (1, 2))
MESH_IDS = [f"{my}x{mx}" for my, mx in MESHES]
TOL_2D = 1e-12
# qgcm_tpu's sharded channel with a split GEMM y-DST fails XLA's HLO
# verifier on two CPU devices ("HLO all-to-all has operands with
# different shapes", on the 2 x 1 and 1 x 2 meshes at every width
# tried), so there the port's solve is held to its single-device solve
# only
QGCM_TPU_FAILS = {(7, 2), (7, (1, 2))}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = {n: spawn_ranks(ranks.solver_rank, n, CASES, backend="gloo",
                          workdir=tmp_path_factory.mktemp(f"solve{n}"),
                          timeout=120)[0]
           for n in RANKS}
    for my, mx in MESHES:
        out[(my, mx)] = spawn_ranks(
            ranks.solver_rank, my * mx, CASES, (my, mx), backend="gloo",
            workdir=tmp_path_factory.mktemp(f"solve{my}x{mx}"),
            timeout=120)[0]
    return out


@functools.lru_cache(maxsize=None)
def single_device(i):
    kind, nyp, nxp, yt, seed = CASES[i]
    base = ranks.base_solver(kind, nyp, nxp, yt)
    rhs = torch.from_numpy(ranks.solver_rng_rhs(kind, nyp, nxp, seed))
    spec = base.forward(rhs) / base._denom() if kind == "box" else None
    return base.solve(rhs).numpy(), spec


@functools.lru_cache(maxsize=None)
def qgcm_tpu_sharded(i, n):
    """qgcm_tpu's sharded solve of case i on n x 1 devices, or on a mesh
    of n = (my, mx); the port's 'sine' y-DST is held to qgcm_tpu's
    'matmul', the dense sine matrix at the heights of CASES."""
    from qgcm_tpu.parallel import spectral as jsp
    from qgcm_tpu.solver.helmholtz import (make_box_helmholtz,
                                           make_cyclic_helmholtz)
    kind, nyp, nxp, yt, seed = CASES[i]
    yt = {"sine": "matmul"}.get(yt, yt)
    my, mx = n if isinstance(n, tuple) else (n, 1)
    mesh = JaxMesh(np.asarray(jax.devices()[:my * mx]).reshape(my, mx),
                   ("y", "x"))
    rhs = jax.numpy.asarray(ranks.solver_rng_rhs(kind, nyp, nxp, seed))
    if kind == "box":
        sh = jsp.ShardedBoxHelmholtz(
            make_box_helmholtz(nxp, nyp, 0.7, 0.9, ranks.RDM2,
                               transform=yt), mesh)
    else:
        sh = jsp.ShardedCyclicHelmholtz(
            make_cyclic_helmholtz(nxp, nyp, 0.7, 0.9, ranks.RDM2,
                                  ytransform=yt), mesh)
    return np.asarray(jax.jit(sh.solve)(rhs))


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_solve_matches_single_device(spawned, i, n):
    """The gathered row blocks are the single-device solution to 1e-13 of
    its maximum; walls and padding rows are zero; a box solve is two
    transposes, a channel solve four."""
    res = spawned[n][i]
    want, _ = single_device(i)
    assert rel_err(res["sol"], want) <= 1e-13
    assert res["pad_zero"]
    assert res["a2a"] == (2 if CASES[i][0] == "box" else 4)
    if CASES[i][0] == "cyclic":       # the duplicate column, bit for bit
        assert np.array_equal(res["sol"][..., -1], res["sol"][..., 0])


@pytest.mark.parametrize("i,n", [(i, n) for i in range(len(CASES))
                                 for n in RANKS
                                 if (i, n) not in QGCM_TPU_FAILS],
                         ids=[f"{IDS[i]}-{n}" for i in range(len(CASES))
                              for n in RANKS
                              if (i, n) not in QGCM_TPU_FAILS])
def test_sharded_solve_matches_qgcm_tpu(spawned, i, n):
    """Within 1e-12 of qgcm_tpu's sharded solver on an n x 1 mesh."""
    assert rel_err(spawned[n][i]["sol"], qgcm_tpu_sharded(i, n)) <= 1e-12


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if c[0] == "box"],
                         ids=[IDS[i] for i, c in enumerate(CASES)
                              if c[0] == "box"])
def test_box_spectrum_padding_is_inert(spawned, i, n):
    """The box spectrum's column chunks, put together, are the
    single-device spectrum over its nxi columns and zero beyond
    (tests/test_spectral.py:90)."""
    spec = spawned[n][i]["spec"]
    _, want = single_device(i)
    nxi = want.shape[-1]
    assert rel_err(spec[..., :nxi], want.numpy()) <= 1e-13
    assert np.all(spec[..., nxi:] == 0.0)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_2d_solve_matches_single_device_and_qgcm_tpu(spawned, i, mesh):
    """The 2-D pencils: the gathered blocks within 1e-12 of the
    single-device solution's maximum and of qgcm_tpu's sharded solve on
    a mesh of the same shape; walls and padding rows and columns zero; a
    solve is four transposes, of which the channel's two along 'y' are no
    collective on a mesh of one row; in the channel the duplicate column
    bit for bit."""
    res = spawned[mesh][i]
    want, _ = single_device(i)
    assert rel_err(res["sol"], want) <= TOL_2D
    if (i, mesh) not in QGCM_TPU_FAILS:
        assert rel_err(res["sol"], qgcm_tpu_sharded(i, mesh)) <= TOL_2D
    assert res["pad_zero"]
    assert res["a2a"] == (2 if CASES[i][0] == "cyclic" and mesh[0] == 1
                          else 4)
    if CASES[i][0] == "cyclic":
        assert np.array_equal(res["sol"][..., -1], res["sol"][..., 0])


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if c[0] == "box"],
                         ids=[IDS[i] for i, c in enumerate(CASES)
                              if c[0] == "box"])
def test_2d_box_spectrum_padding_is_inert(spawned, i, mesh):
    """On a 2-D mesh the spectrum keeps the rows mesh's layout: its
    y-pencil chunks, put together in rank order, are the single-device
    spectrum over its nxi columns, and zero beyond."""
    spec = spawned[mesh][i]["spec"]
    _, want = single_device(i)
    nxi = want.shape[-1]
    assert rel_err(spec[..., :nxi], want.numpy()) <= 1e-13
    assert np.all(spec[..., nxi:] == 0.0)


def test_one_rank_mesh_solves_on_its_own():
    """Without a process group a mesh is one rank, and the sharded
    solvers are the single-device ones to roundoff, with no collective
    but the trivial transposes."""
    mesh = make_mesh(rows_only=True)
    for i in (0, 1):
        kind, nyp, nxp, yt, seed = CASES[i]
        base = ranks.base_solver(kind, nyp, nxp, yt)
        cls = ShardedBoxHelmholtz if kind == "box" else ShardedCyclicHelmholtz
        rhs = torch.from_numpy(ranks.solver_rng_rhs(kind, nyp, nxp, seed))
        got = cls(base, mesh).solve(rhs)
        assert rel_err(got, single_device(i)[0]) <= 1e-13


def _fake_mesh(my, mx, rank, grid=None):
    """A Mesh of (my, mx) as rank `rank` sees it, made without a process
    group (no collective is called on it)."""
    from qgcm_torch.parallel.mesh import Mesh
    fake = Mesh.__new__(Mesh)
    fake.my, fake.mx, fake.size, fake.rank = my, mx, my * mx, rank
    fake.iy, fake.ix = divmod(rank, mx)
    fake.grid, fake.group = grid, None
    if grid is not None:
        fake.by, fake.bx = fake.block(grid[0], "y"), fake.block(grid[1], "x")
    return fake


def test_wrap_inversions_and_2d_refusal():
    """wrap_inversions swaps the ocean's solver for its sharded form and
    leaves the rest of the inversion, on a rows mesh and on an x > 1
    mesh; what stays refused on an x > 1 mesh is a channel's ocean in
    the substep given a halo variant (the duplicated column's
    wraparound, qgcm_tpu's reason), and blocks too thin for the mixed
    layer; a channel's --mesh 1x2, which is cut by rows over its 2
    ranks, needs those ranks."""
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import check_mesh_grid
    from qgcm_torch.parallel.mesh import mesh_from_spec
    model = build_model(ranks.small_cfg(cyclic=False), "cpu")
    for mesh in (make_mesh(rows_only=True), _fake_mesh(1, 2, 1)):
        wrapped = wrap_inversions(model, mesh)
        assert isinstance(wrapped.inv_oc.helm, ShardedBoxHelmholtz)
        assert wrapped.inv_oc.cdhinv is model.inv_oc.cdhinv
        assert dataclasses.replace(wrapped, inv_oc=model.inv_oc) == model
    cfg = ranks.small_cfg(cyclic=True)
    grid = (cfg.nypo, cfg.nxpo)
    with pytest.raises(ValueError, match="duplicated east column"):
        check_mesh_grid(cfg, _fake_mesh(1, 2, 0, grid))
    with pytest.raises(ValueError, match="a 1x2 mesh needs 2 ranks"):
        mesh_from_spec("1x2", True, grid)
    box = ranks.small_cfg(cyclic=False)
    with pytest.raises(ValueError, match="too thin"):
        check_mesh_grid(box, _fake_mesh(1, 30, 0, (box.nypo, box.nxpo)))
    check_mesh_grid(box, _fake_mesh(2, 2, 3, (box.nypo, box.nxpo)))
