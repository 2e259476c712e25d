"""qgcm_torch's decomposed coupled model, in float64 on the CPU in real
gloo ranks (rows meshes of 2 and 4 ranks): the decomposed xforc against
qgcm_tpu's make_xforc(model, mesh) on a mesh of the same shape at 1e-12
of each output's maximum, with tau_udiff off and on, in the box and the
channel and over a footprint that reaches the atmosphere's wall bands;
the decomposed coupled runner against qgcm_tpu's mesh runner over 2
coupling cycles at 1e-11 (tests/test_sharding.py:41-58); the box's
xforc and runner on a 2x2 mesh the same way, the atmosphere on row
blocks over the ranks; every rank's atmosphere and atmospheric forcing
the same bits where they are replicated; bicubic_refine_window against
qgcm_tpu's, and the refinement by row and column range; and what the
mesh paths refuse."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import _torch_ranks as ranks
from qgcm_torch.coupling import (bicubic_refine_uv, bicubic_refine_window,
                                 make_xforc)
from qgcm_torch.models.stepper import make_coupled_runner
from qgcm_torch.parallel.launch import spawn_ranks
from qgcm_torch.parallel.mesh import atmos_mesh, make_mesh, shard_tree

from test_torch_cases import (one_torch_thread, quick_compile, rel_err,
                              to_jax)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

XFORC_TOL = 1e-12
RUNNER_TOL = 1e-11
CYCLES = 2
RANKS = (2, 4)
# (kind, config overrides); nyta 8 puts the box's footprint on the
# atmosphere's wall bands (qgcm_tpu's _footprint_interior is false)
XFORC_CASES = [("box", {}), ("box", dict(tau_udiff=True)),
               ("channel", {}), ("channel", dict(tau_udiff=True)),
               ("box", dict(nyta=8, tau_udiff=True))]
XFORC_IDS = ["box", "box-tau_udiff", "channel", "channel-tau_udiff",
             "box-wall-footprint"]
RUNNER_CASES = [("box", dict(tau_udiff=True), "overlap", CYCLES),
                ("channel", {}, "overlap", CYCLES)]
SPECS = ("auto", "rows", "hybrid", "2x1", "1x2", "2x2", "rows2")
# the box on a 2x2 mesh: xforc with tau_udiff off and on, the runner with
# tau_udiff (the ocean's 17 x 17 p grid: ragged last blocks of 8 rows and
# columns)
MESH_2D = (2, 2)
XFORC_2D = [0, 1]
RUNNER_2D = [0]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = {n: spawn_ranks(ranks.coupled_rank, n, XFORC_CASES, RUNNER_CASES,
                          SPECS, backend="gloo",
                          workdir=tmp_path_factory.mktemp(f"coupled{n}"),
                          timeout=120)
           for n in RANKS}
    out[MESH_2D] = spawn_ranks(
        ranks.coupled_rank, 4, [XFORC_CASES[i] for i in XFORC_2D],
        [RUNNER_CASES[i] for i in RUNNER_2D], (), MESH_2D, backend="gloo",
        workdir=tmp_path_factory.mktemp("coupled2x2"), timeout=120)
    return out


def _jax_model(kind, over):
    import qgcm_tpu.config
    from qgcm_tpu.model import build_model as jax_build
    return jax_build(ranks.coupled_cfg(qgcm_tpu.config, kind, **over))


def _jax_states(oc, at):
    from qgcm_tpu.state import AtmosState, OceanState
    return to_jax(OceanState, oc), to_jax(AtmosState, at)


def _jax_mesh(n):
    """n x 1 devices, or a mesh of n = (my, mx)."""
    my, mx = n if isinstance(n, tuple) else (n, 1)
    return JaxMesh(np.asarray(jax.devices()[:my * mx]).reshape(my, mx),
                   ("y", "x"))


@pytest.mark.parametrize("kind", ["box", "channel"])
def test_refine_window_matches_qgcm_tpu(kind):
    """The ocean window of the refinement against qgcm_tpu's
    bicubic_refine_window at 1e-12, and every row range of the fine grid
    bit for bit the rows of the whole."""
    from qgcm_tpu.coupling import bicubic_refine_window as jax_window
    model, _, at = ranks.seeded_coupled(kind)
    cfg = model.cfg
    jm = _jax_model(kind, {})
    rng = np.random.default_rng(2)
    u, v = (rng.standard_normal((cfg.nypa, cfg.nxpa)) for _ in range(2))
    u[:, -1], v[:, -1] = u[:, 0], v[:, 0]
    want = jax_window(jm.coupling, jax.numpy.asarray(u),
                      jax.numpy.asarray(v), jm.cfg)
    got = bicubic_refine_window(model.coupling, torch.from_numpy(u),
                                torch.from_numpy(v), cfg)
    for g, w in zip(got, want):
        assert g.shape == (cfg.nypo, cfg.nxpo)
        assert rel_err(g, w) <= XFORC_TOL
    whole = bicubic_refine_uv(model.coupling, torch.from_numpy(u),
                              torch.from_numpy(v), cfg.ndxr)
    for lo, hi in ((0, 3), (2, 9), (5, 30), (cfg.nypaor - 7, cfg.nypaor)):
        part = bicubic_refine_uv(model.coupling, torch.from_numpy(u),
                                 torch.from_numpy(v), cfg.ndxr, lo, hi)
        for p, w in zip(part, whole):
            assert torch.equal(p, w[lo:hi]), (lo, hi)
    # column ranges (a 2-D mesh's): the same arithmetic on fewer coarse
    # cells, within roundoff of the whole (the products' order may
    # differ); the duplicated east column is the west one's
    n = cfg.nxpaor
    for lo, hi, clo, chi in ((0, 3, 0, 5), (2, 9, 3, 17), (5, 30, 40, n),
                             (3, 11, 1, n), (0, 10, n - 1, n)):
        part = bicubic_refine_uv(model.coupling, torch.from_numpy(u),
                                 torch.from_numpy(v), cfg.ndxr, lo, hi, clo,
                                 chi)
        for p, w in zip(part, whole):
            assert p.shape == (hi - lo, chi - clo)
            assert rel_err(p, w[lo:hi, clo:chi]) <= 1e-15, (clo, chi)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", range(len(XFORC_CASES)), ids=XFORC_IDS)
def test_decomposed_xforc_matches_qgcm_tpu_mesh_xforc(spawned, case, n):
    """Every output of the decomposed xforc (the ocean forcing gathered
    whole) within 1e-12 of its maximum of qgcm_tpu's mesh xforc on n
    devices; the atmospheric forcing and the diagnostics the same bits on
    every rank; padding rows zero; one all_reduce, and in tau_udiff one
    exchange of ghost rows (two directions), and the channel's wall
    sums."""
    from qgcm_tpu.coupling import make_xforc as jax_make_xforc
    kind, over = XFORC_CASES[case]
    _, oc, at = ranks.seeded_coupled(kind, **over)
    ocj, atj = _jax_states(oc, at)
    fn = jax.jit(jax_make_xforc(_jax_model(kind, over), mesh=_jax_mesh(n)))
    args = (atj.pam, ocj.pom, ocj.sstm, atj.astm, atj.hmixam)
    want = quick_compile(fn, *args)(*args)
    res = [r["xforc"][case] for r in spawned[n]]
    for key, w_nt in zip(("ofor", "afor", "diags"), want):
        for name, w in w_nt._asdict().items():
            assert rel_err(res[0][key][name], np.asarray(w)) <= XFORC_TOL, \
                (key, name)
            if key != "ofor":
                assert all(np.array_equal(r[key][name], res[0][key][name])
                           for r in res[1:]), (key, name)
    for r in res[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["scalars"], res[0]["scalars"]))
    assert all(r["pad_zero"] for r in res)
    want_counts = {"coupling.sums": 1, "coupling.gather": 1}
    if over.get("tau_udiff"):
        want_counts["coupling.rows"] = 2
    if kind == "channel":
        want_counts["ocean.forcing.walls"] = 1
    assert res[0]["counts"] == want_counts


def _jax_mesh_runner(kind, over, n, steps):
    from qgcm_tpu.models.stepper import make_coupled_runner as jax_runner
    from qgcm_tpu.parallel.mesh import shard_tree as jax_shard
    _, oc, at = ranks.seeded_coupled(kind, **over)
    ocj, atj = _jax_states(oc, at)
    mesh = _jax_mesh(n)
    run = jax_runner(_jax_model(kind, over), mesh=mesh, halo_variant="overlap",
                     spectral_variant="a2a")
    with pytest.MonkeyPatch.context() as mp:
        from test_torch_cases import quick_jit
        quick_jit(mp)
        o, a = run(jax_shard(ocj, mesh), jax_shard(atj, mesh), steps)
    return ({k: np.asarray(v) for k, v in o._asdict().items()},
            {k: np.asarray(v) for k, v in a._asdict().items()})


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", [0, 1], ids=["box-tau_udiff", "channel"])
def test_coupled_mesh_runner_matches_qgcm_tpu(spawned, case, n):
    """2 coupling cycles of the decomposed coupled runner ('overlap' +
    'a2a') on n ranks against qgcm_tpu's mesh runner on n devices: every
    field of both fluids within 1e-11 of its maximum (the integrals
    dpio*/dpia* against area x max|p|, as tests/test_torch_coupled.py
    holds them); every rank's atmosphere (its row blocks gathered) and
    its replicated leaves the same bits; the kernel path
    launches nothing on CPU tensors; padding rows stay zero."""
    kind, over, _, cycles = RUNNER_CASES[case]
    model, _, _ = ranks.seeded_coupled(kind, **over)
    cfg, g = model.cfg, model.grids
    want_o, want_a = _jax_mesh_runner(kind, over, n, cycles * cfg.nstr)
    res = [r["runner"][case] for r in spawned[n]]
    scale = {"dpioc": g.dxo * g.dyo * np.abs(want_o["po"]).max(),
             "dpiocp": g.dxo * g.dyo * np.abs(want_o["pom"]).max(),
             "dpiat": g.dxa * g.dya * np.abs(want_a["pa"]).max(),
             "dpiatp": g.dxa * g.dya * np.abs(want_a["pam"]).max()}
    for got, want in ((res[0]["ocean"], want_o), (res[0]["atmos"], want_a)):
        for name, w in want.items():
            s = scale.get(name, np.abs(w).max() + 1e-300)
            assert np.abs(got[name] - w).max() <= RUNNER_TOL * s, name
    for r in res[1:]:
        for name, a in res[0]["atmos"].items():
            assert np.array_equal(r["atmos"][name], a), name
        for name, a in res[0]["replicated"].items():
            assert np.array_equal(r["replicated"][name], a), name
    assert all(r["pad_zero"] for r in res)
    assert res[0]["launches"] == 0


@pytest.mark.parametrize("n", RANKS)
def test_coupled_mesh_runner_matches_single_device(spawned, n):
    """The same runs against the port's single-device coupled runner at
    1e-11 of each field's maximum, and the collectives of a cycle: the
    decomposed xforc's (one all_reduce, tau_udiff's exchange) beside the
    ocean substep's."""
    for case, (kind, over, _, cycles) in enumerate(RUNNER_CASES):
        model, oc, at = ranks.seeded_coupled(kind, **over)
        ro, ra = make_coupled_runner(model)(oc, at, cycles * model.cfg.nstr)
        got = spawned[n][0]["runner"][case]
        for name in ("po", "qo", "sst"):
            assert rel_err(got["ocean"][name], getattr(ro, name)) <= \
                RUNNER_TOL, name
        for name in ("pa", "qa", "ast", "hmixa"):
            assert rel_err(got["atmos"][name], getattr(ra, name)) <= \
                RUNNER_TOL, name
        counts = got["counts"]
        assert counts["coupling.sums"] == 1
        assert counts.get("coupling.rows", 0) == (2 if over else 0)
        assert counts["halo.rows"] == 2 and counts["ocean.oml.sums"] == 2


def test_mesh_specs(spawned):
    """--mesh on 2 and 4 ranks: auto and rows put every rank on y, so
    does hybrid in a channel, where a box's hybrid mesh puts the host's
    ranks on x (one host: 1 x n); a box takes NYxNX of as many ranks as
    the group has; a channel's NYxNX of as many ranks, NX > 1 included,
    is cut by rows over all of them (where qgcm_tpu falls back to GSPMD);
    a misspelt spec raises."""
    for n in RANKS:
        box, channel = spawned[n][0]["specs"]
        for got in (box, channel):
            assert got[0] == got[1] == (n, 1)
            assert got[3] == ((2, 1) if n == 2 else
                              ("ValueError", "a 2x1 mesh needs 2 ranks, the "
                               f"group has {n}"))
            assert got[6][0] == "ValueError"
        assert channel[2] == (n, 1)
        assert box[2] == (1, n)
        assert box[4] == ((1, 2) if n == 2 else
                          ("ValueError", "a 1x2 mesh needs 2 ranks, the "
                           f"group has {n}"))
        assert box[5] == ((2, 2) if n == 4 else
                          ("ValueError", "a 2x2 mesh needs 4 ranks, the "
                           f"group has {n}"))
        assert channel[4] == ((2, 1) if n == 2 else
                              ("ValueError", "a 1x2 mesh needs 2 ranks, the "
                               f"group has {n}"))
        assert channel[5] == ((4, 1) if n == 4 else
                              ("ValueError", "a 2x2 mesh needs 4 ranks, the "
                               f"group has {n}"))


@pytest.mark.parametrize("case", XFORC_2D,
                         ids=[XFORC_IDS[i] for i in XFORC_2D])
def test_2d_xforc_matches_qgcm_tpu_mesh_xforc(spawned, case):
    """The box's decomposed xforc on a 2x2 mesh (the fine grid cut by
    rows and columns) against qgcm_tpu's mesh xforc on 2x2 devices: every
    output within 1e-12 of its maximum; the atmospheric forcing and the
    diagnostics the same bits on every rank; padding zero; one
    all_reduce, and in tau_udiff one exchange of ghost rows and one of
    ghost columns."""
    from qgcm_tpu.coupling import make_xforc as jax_make_xforc
    kind, over = XFORC_CASES[case]
    _, oc, at = ranks.seeded_coupled(kind, **over)
    ocj, atj = _jax_states(oc, at)
    fn = jax.jit(jax_make_xforc(_jax_model(kind, over),
                                mesh=_jax_mesh(MESH_2D)))
    args = (atj.pam, ocj.pom, ocj.sstm, atj.astm, atj.hmixam)
    want = quick_compile(fn, *args)(*args)
    res = [r["xforc"][XFORC_2D.index(case)] for r in spawned[MESH_2D]]
    for key, w_nt in zip(("ofor", "afor", "diags"), want):
        for name, w in w_nt._asdict().items():
            assert rel_err(res[0][key][name], np.asarray(w)) <= XFORC_TOL, \
                (key, name)
            if key != "ofor":
                assert all(np.array_equal(r[key][name], res[0][key][name])
                           for r in res[1:]), (key, name)
    for r in res[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(r["scalars"], res[0]["scalars"]))
    assert all(r["pad_zero"] for r in res)
    want_counts = {"coupling.sums": 1, "coupling.gather": 1}
    if over.get("tau_udiff"):
        want_counts.update({"coupling.rows": 2, "coupling.cols": 2})
    assert res[0]["counts"] == want_counts


def test_2d_coupled_runner_matches_qgcm_tpu_and_single_device(spawned):
    """2 coupling cycles of the box with tau_udiff on a 2x2 mesh against
    qgcm_tpu's mesh runner on 2x2 devices (every field of both fluids
    within 1e-11 of its maximum, the integrals against area x max|p|) and
    against the port's single-device runner at 1e-11; every rank's
    atmosphere (gathered) and its replicated leaves the same bits;
    padding zero; the cycle's collectives."""
    kind, over, _, cycles = RUNNER_CASES[RUNNER_2D[0]]
    model, oc, at = ranks.seeded_coupled(kind, **over)
    cfg, g = model.cfg, model.grids
    want_o, want_a = _jax_mesh_runner(kind, over, MESH_2D, cycles * cfg.nstr)
    res = [r["runner"][0] for r in spawned[MESH_2D]]
    scale = {"dpioc": g.dxo * g.dyo * np.abs(want_o["po"]).max(),
             "dpiocp": g.dxo * g.dyo * np.abs(want_o["pom"]).max(),
             "dpiat": g.dxa * g.dya * np.abs(want_a["pa"]).max(),
             "dpiatp": g.dxa * g.dya * np.abs(want_a["pam"]).max()}
    for got, want in ((res[0]["ocean"], want_o), (res[0]["atmos"], want_a)):
        for name, w in want.items():
            s = scale.get(name, np.abs(w).max() + 1e-300)
            assert np.abs(got[name] - w).max() <= RUNNER_TOL * s, name
    ro, ra = make_coupled_runner(model)(oc, at, cycles * cfg.nstr)
    for name in ("po", "qo", "sst"):
        assert rel_err(res[0]["ocean"][name], getattr(ro, name)) <= \
            RUNNER_TOL, name
    for name in ("pa", "qa", "ast", "hmixa"):
        assert rel_err(res[0]["atmos"][name], getattr(ra, name)) <= \
            RUNNER_TOL, name
    for r in res[1:]:
        for name, a in res[0]["atmos"].items():
            assert np.array_equal(r["atmos"][name], a), name
        for name, a in res[0]["replicated"].items():
            assert np.array_equal(r["replicated"][name], a), name
    assert all(r["pad_zero"] for r in res)
    counts = res[0]["counts"]
    assert counts["coupling.sums"] == 1
    assert counts["coupling.rows"] == counts["coupling.cols"] == 2
    assert counts["halo.rows"] == counts["halo.cols"] == 2
    # the ocean's box solve on 2x2 (4 transposes) and the atmosphere's
    # channel solves on its rows mesh (4 each, nstr a cycle)
    assert counts["spectral.a2a"] == 4 + 4 * cfg.nstr


def test_mesh_refusals():
    """What the coupled mesh paths take where qgcm_tpu takes GSPMD, and
    what they refuse. halo_variant None and spectral_variant None run as
    'overlap' and 'a2a' (on a one-rank mesh the same bits as with those
    variants named); a mesh made for another grid is refused, and so is
    a channel given a halo variant on a mesh with x > 1 (the duplicated
    column's wraparound, qgcm_tpu's halo path's refusal), before the
    mesh is used."""
    model, oc, at = ranks.seeded_coupled("box")
    cfg = model.cfg
    mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
    blocks = shard_tree(oc, mesh), shard_tree(at, atmos_mesh(mesh, cfg))
    want = make_coupled_runner(model, mesh=mesh, halo_variant="overlap",
                               spectral_variant="a2a")(*blocks, cfg.nstr)
    for kw in (dict(halo_variant=None, spectral_variant="a2a"),
               dict(halo_variant="overlap", spectral_variant=None)):
        got = make_coupled_runner(model, mesh=mesh, **kw)(*blocks, cfg.nstr)
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), kw
    with pytest.raises(ValueError, match="grid"):
        make_xforc(model, mesh=make_mesh(rows_only=True, grid=(9, 9)))
    from types import SimpleNamespace
    channel, _, _ = ranks.seeded_coupled("channel")
    c = channel.cfg
    fake = SimpleNamespace(grid=(c.nypo, c.nxpo), my=1, mx=2)
    with pytest.raises(ValueError, match="duplicated east column"):
        make_coupled_runner(channel, mesh=fake, halo_variant="overlap",
                            spectral_variant="a2a")
