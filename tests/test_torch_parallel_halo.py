"""qgcm_torch.parallel: the decomposed vorticity step (halo.py) and the
kernel's window modes (ops.qgstep row0/ny_total and x_ext), in float64
on the CPU, in real gloo ranks.

The ranks (tests/_torch_ranks.py, started with the spawn method, no JAX)
step the seeded state of tests/test_halo.py's ocean on rows meshes of 2
and 4 ranks and on box 2-D meshes (2x2, 1x2); the gathered blocks must
be bit for bit the port's single-device step, as qgcm_tpu's halo step
is its own (tests/test_halo.py:55,150), and within 1e-12 max|q| of
qgcm_tpu's _qgostep_halo on the conftest's 8-device CPU mesh. The
collective counts are pinned per schedule as tests/test_halo.py:118,212
pin XLA's."""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh as JaxMesh

import _torch_ranks as ranks
from qgcm_torch.ops.qgstep import qgstep, window_reference
from qgcm_torch.parallel.launch import spawn_ranks

from test_torch_cases import one_torch_thread, rel_err

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = 1e-12
VARIANTS = ("staged", "deep", "overlap", "local")
# (cyclic, sponge, mesh, variants) of the 4-rank and 2-rank runs
CASES4 = [(False, False, "rows", VARIANTS), (True, False, "rows", VARIANTS),
          (True, True, "rows", ("deep", "overlap")),
          (False, False, (2, 2), ("staged", "deep", "overlap", "local")),
          (False, True, (2, 2), ("deep", "overlap")),
          (True, False, (2, 2), ("deep",))]
CASES2 = [(False, False, "rows", VARIANTS), (True, False, "rows", VARIANTS),
          (False, False, (1, 2), ("deep", "overlap"))]
# collectives of one step, by schedule: an exchange is one collective
# per direction, as qgcm_tpu's collective-permutes
COUNTS_ROWS = {"staged": {"halo.rows": 6}, "deep": {"halo.rows": 2},
               "overlap": {"halo.rows": 2}, "local": {"halo.gather": 1}}
COUNTS_2D = {"deep": {"halo.rows": 2, "halo.cols": 2},
             "overlap": {"halo.rows": 2, "halo.cols": 2},
             "staged": {"halo.rows": 2, "halo.cols": 2},
             "local": {"halo.gather": 1}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{n_ranks: results of _torch_ranks.halo_rank} for 4 and 2 ranks."""
    out = {}
    for n, cases in ((4, CASES4), (2, CASES2)):
        work = tmp_path_factory.mktemp(f"halo{n}")
        out[n] = spawn_ranks(ranks.halo_rank, n, cases, backend="gloo",
                             workdir=work, timeout=120)[0]
    return out


@functools.lru_cache(maxsize=None)
def single_device(cyclic, sponge):
    """The port's single-device step of the seeded case (ops.qgstep on
    CPU tensors: the plain chain)."""
    cfg = ranks.small_cfg(cyclic, sponge)
    args = ranks.halo_args(cfg)
    return qgstep(*args, cyclic=cyclic, sponge=sponge).numpy()


@functools.lru_cache(maxsize=None)
def jax_halo(cyclic, sponge, shape, variant):
    """qgcm_tpu's _qgostep_halo of the same inputs on the conftest's CPU
    devices, jitted (its eager shard_map dispatch takes minutes)."""
    import qgcm_tpu.config
    from test_torch_cases import to_jax
    from qgcm_tpu.model import build_model as jax_build
    from qgcm_tpu.models.ocean import _qgostep_halo
    from qgcm_tpu.state import OceanForcing, OceanState
    from qgcm_torch.models.ocean import _oml
    cfg = ranks.small_cfg(cyclic, sponge, cfgmod=qgcm_tpu.config)
    jm = jax_build(cfg.replace(solver_transform="fft"))
    model, st, f = ranks.seeded_state(ranks.small_cfg(cyclic, sponge))
    entoc = jax.numpy.asarray(_oml(model, st, f)[2].numpy())
    my, mx = (4, 1) if shape == "rows" else shape
    mesh = JaxMesh(np.asarray(jax.devices()[:my * mx]).reshape(my, mx),
                   ("y", "x"))
    fn = jax.jit(functools.partial(_qgostep_halo, jm, mesh=mesh,
                                   variant=variant, use_pallas=False))
    q, _, _ = fn(to_jax(OceanState, st), to_jax(OceanForcing, f), entoc)
    return np.asarray(q)


def _result(spawned, n, case, variant):
    cases = CASES4 if n == 4 else CASES2
    i = next(i for i, c in enumerate(cases) if c[:3] == case)
    return spawned[n][i][variant]


BIT_CASES = ([(4, c[:3], v) for c in CASES4 if not (c[0] and c[2] != "rows")
              for v in c[3]]
             + [(2, c[:3], v) for c in CASES2 for v in c[3]])


@pytest.mark.parametrize("n,case,variant", BIT_CASES,
                         ids=[f"{n}ranks-{'cyc' if c[0] else 'box'}"
                              f"{'-sponge' if c[1] else ''}-{c[2]}-{v}"
                              for n, c, v in BIT_CASES])
def test_halo_step_bit_equal_to_single_device(spawned, n, case, variant):
    """Every schedule, on every mesh, is the single-device step bit for
    bit; its collectives are the schedule's."""
    res = _result(spawned, n, case, variant)
    assert res[0] == "ok", res
    want = single_device(case[0], case[1])
    assert np.array_equal(res[1], want)
    pinned = COUNTS_ROWS if case[2] == "rows" else COUNTS_2D
    assert res[2] == pinned[variant]


JAX_CASES = [(False, False, "rows", v) for v in ("staged", "deep", "overlap")]
JAX_CASES += [(True, False, "rows", v) for v in ("staged", "deep", "overlap")]
JAX_CASES += [(False, False, (2, 2), v) for v in ("deep", "overlap")]


@pytest.mark.parametrize("cyclic,sponge,shape,variant", JAX_CASES,
                         ids=[f"{'cyc' if c else 'box'}-{s}-{v}"
                              for c, _, s, v in JAX_CASES])
def test_halo_step_matches_qgcm_tpu(spawned, cyclic, sponge, shape,
                                    variant):
    """Within 1e-12 max|q| of qgcm_tpu's _qgostep_halo on a mesh of the
    same shape."""
    res = _result(spawned, 4, (cyclic, sponge, shape), variant)
    assert rel_err(res[1], jax_halo(cyclic, sponge, shape, variant)) <= TOL


def test_channel_refuses_x_decomposition(spawned):
    """A channel on a mesh with x > 1 is refused (halo.py:379-385)."""
    res = _result(spawned, 4, (True, False, (2, 2)), "deep")
    assert res[0] == "raised" and "rows" in res[1]


@pytest.mark.parametrize("cyclic,sponge", [(False, False), (True, False),
                                           (True, True)])
def test_window_reference_matches_qgcm_tpu_chain(cyclic, sponge):
    """The plain windowed chain (ops.qgstep.window_reference, the port of
    halo.py::_chain) against qgcm_tpu's _chain on the same windows: a
    9-row band inside the grid, the south band with the wall, and a
    window over the north wall whose last rows are padding."""
    from qgcm_tpu.parallel.halo import _chain
    cfg = ranks.small_cfg(cyclic, sponge)
    (pom, po, qo, qom, wek, ent, rspl, consts, ah2, ah4) = ranks.halo_args(
        cfg)
    ny = pom.shape[1]
    geom = (ny, pom.shape[2], pom.shape[0], cyclic, sponge) + consts + (
        tuple(ah2), tuple(ah4))
    pad = lambda f: F.pad(f, (0, 0, 3, 6))       # noqa: E731
    for r0, n in ((7, 3), (0, 3), (ny - 4, 7)):
        win = [pad(f)[:, r0:r0 + n + 6].contiguous() for f in (pom, po, qo)]
        core = [pad(f)[..., r0 + 3:r0 + 3 + n, :].contiguous()
                for f in (qom, wek, ent, rspl if sponge else wek)]
        got = window_reference(*win, *core[:3],
                               core[3] if sponge else None, consts, ah2,
                               ah4, cyclic=cyclic, sponge=sponge,
                               row0=r0 - 3, ny_total=ny)
        want = _chain(*(jax.numpy.asarray(t.numpy()) for t in win + core),
                      r0 - 3, geom)
        assert rel_err(got, np.asarray(want)) <= TOL
        assert got.shape == (pom.shape[0], n, pom.shape[2])


def test_window_reference_2d_matches_qgcm_tpu_chain2():
    """The x_ext window's plain version against qgcm_tpu's _chain2 on a
    ghost-ring window at the box's south-west corner and one inside."""
    from qgcm_tpu.parallel.halo import _chain2
    cfg = ranks.small_cfg(False, True)
    (pom, po, qo, qom, wek, ent, rspl, consts, ah2, ah4) = ranks.halo_args(
        cfg)
    ny, nx = pom.shape[1:]
    geom = (ny, nx, pom.shape[0], False, True) + consts + (tuple(ah2),
                                                            tuple(ah4))
    pad = lambda f: F.pad(f, (3, 3, 3, 3))       # noqa: E731
    for r0, c0, n, m in ((0, 0, 8, 9), (6, 11, 5, 12)):
        win = [pad(f)[:, r0:r0 + n + 6, c0:c0 + m + 6].contiguous()
               for f in (pom, po, qo)]
        core = [f[..., r0:r0 + n, c0:c0 + m].contiguous()
                for f in (qom, wek, ent, rspl)]
        got = window_reference(*win, *core, consts, ah2, ah4, cyclic=False,
                               sponge=True, row0=r0 - 3, ny_total=ny,
                               col0=c0, nx_total=nx, x_ext=True)
        want = _chain2(*(jax.numpy.asarray(t.numpy()) for t in win + core),
                       r0 - 3, c0 - 3, geom)
        assert rel_err(got, np.asarray(want)) <= TOL


def test_window_mode_arguments_refused():
    """Window arguments without row0, x_ext windows of a channel, and a
    row window narrower than the grid are refused."""
    cfg = ranks.small_cfg(True)
    args = ranks.halo_args(cfg)
    with pytest.raises(ValueError, match="row0"):
        qgstep(*args, cyclic=True, sponge=False, ny_total=9)
    win = [F.pad(f, (3, 3, 3, 3)).contiguous() for f in args[:3]]
    with pytest.raises(ValueError, match="box"):
        qgstep(*win, *args[3:], cyclic=True, sponge=False, row0=-3,
               ny_total=args[0].shape[1], x_ext=True)
    with pytest.raises(ValueError, match="whole width"):
        qgstep(*(F.pad(f, (0, 0, 3, 3)).contiguous() for f in args[:3]),
               *args[3:], cyclic=True, sponge=False, row0=-3,
               ny_total=args[0].shape[1], col0=2)

