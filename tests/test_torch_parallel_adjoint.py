"""The distributed adjoint of qgcm_torch (adjoint.ocean_sensitivity with a
mesh and a halo variant), on the CPU in float64 in real gloo ranks, over
10 substeps of the test ocean of tests/_torch_ranks.py (2 layers, 25 x
49), in one spawn of 4 ranks: against the port's own single-device
gradient on rows meshes of 2 ranks (a group of two of the 4) and 4
ranks (the channel too, whose middle ranks hold no wall row) and on 2x2
and 1x4 meshes, with each halo schedule (the forcing
gradients within 1e-13 of their maximum, state0's within 1e-12, the
value within 1e-12: tests/test_adjoint.py:262-268's bars); remat True, 4
and "dots" and host segments against the stored one-program gradient at
1e-12; the gradient's padding, the replicated results' bits on every
rank, the backward's collectives against the forward's and every
rank's collectives against rank 0's; the coupled model's distributed
adjoint (make_coupled_runner(mesh, remat=True) differentiated, the
atmosphere on row blocks) against the port's single-device coupled
gradient; the gradient of
the vorticity step alone through each schedule ('local' where the blocks
are too small for ghosts) against the single-device step's; and
qgcm_tpu's distributed adjoint (tests/test_adjoint.py:226's call, 4 rows
devices) at 1e-11.

The file holds two tests, each checking many cases (the failing case is
named in the assertion): pytest-xdist's --dist loadfile queues files by
their number of tests, so a file of few tests runs among the last and
leaves the other files' placement on the workers as it was. The window
rule's own tests are in tests/test_torch_qgstep.py."""

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from qgcm_torch.adjoint import ocean_sensitivity
from qgcm_torch.ops.qgstep import qgstep
from qgcm_torch.parallel.launch import spawn_ranks

from test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

STEPS = 10
FORCING_TOL = 1e-13
STATE_TOL = 1e-12
VALUE_TOL = 1e-12
JAX_TOL = 1e-11
REMAT_TOL = 1e-12
COUPLED_TOL = 1e-11
SEGMENT = 5

# (kind, mesh shape, halo variant, remat, segment_steps)
CASES_2 = [("box", "rows", v, False, 0) for v in ("staged", "deep",
                                                   "overlap")] + [
    ("channel", "rows", "overlap", False, 0)]
CASES_4 = [("box", "rows", v, False, 0) for v in ("staged", "deep",
                                                   "overlap")] + [
    ("box", shape, v, False, 0) for shape in ((2, 2), (1, 4))
    for v in ("overlap", "deep")] + [
    ("channel", "rows", "overlap", False, 0)] + [
    ("box", "rows", "overlap", r, 0) for r in (True, 4, "dots")] + [
    ("box", "rows", "overlap", True, SEGMENT)]
# the vorticity step alone: (cyclic, sponge, mesh shape, variant,
# nyaooc); on 4 rows ranks nyaooc 3 leaves 7 rows in blocks of 2, too few
# for ghosts: 'local' is taken
HALO_CASES = [(False, False, "rows", v, 12) for v in ("staged", "deep",
                                                      "overlap")] + [
    (True, True, "rows", "overlap", 12), (False, False, "rows", "overlap", 3),
    (False, False, (2, 2), "overlap", 12), (False, True, (2, 2), "local", 12)]


# the coupled model's distributed adjoint: (kind, config overrides, mesh
# shape, halo variant, remat) over CYCLES coupling cycles of the small
# coupled double gyre (tests/test_adjoint.py:157-190's grid, its
# atmosphere's 13 rows in blocks of 4 on 4 ranks); nyta 24 gives 25
# atmosphere rows in blocks of 7, so that rank 1 holds no row of the
# wall strips (rows 0-4 and 20-24)
CYCLES = 2
COUPLED_CASES = [("box", {}, "rows", "overlap", True),
                 ("box", {}, (2, 2), "overlap", True),
                 ("box", dict(nyta=24), "rows", "overlap", True)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ranks' results, from one spawn of 4 ranks: out[n] the adjoint
    cases on n ranks (n = 2: a group of ranks 0 and 1), rank by rank;
    out['halo'] rank 0's results of HALO_CASES; out['coupled'] the
    COUPLED_CASES, rank by rank."""
    four = spawn_ranks(ranks.adjoint_rank, 4, CASES_4, STEPS, HALO_CASES,
                       CASES_2, COUPLED_CASES, CYCLES, backend="gloo",
                       workdir=tmp_path_factory.mktemp("adj"), timeout=180)
    return {2: [r["pair"] for r in four[:2]],
            4: [r["adjoint"] for r in four], "halo": four[0]["halo"],
            "coupled": [r["coupled"] for r in four]}


@pytest.fixture(scope="module")
def single():
    """The port's single-device gradients (every step stored) by kind."""
    out = {}
    for kind in ("box", "channel"):
        model, st, mf, obj = ranks.adjoint_setup(kind)
        out[kind] = ocean_sensitivity(model, obj, remat=False)(st, mf,
                                                                STEPS)
    return out


def rel(a, b) -> float:
    """max|a - b| / max|b|; max|a| where b is zero."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else \
        float(np.abs(a).max())


def test_distributed_gradient_matches_single_device(spawned, single):
    """The ranks' gradients: every schedule and mesh against the
    single-device gradient (_check_meshes), remat and segments against
    the stored gradient (_check_remat), padding and replicated bits
    (_check_replicated), the backward's collectives (_check_counts), and
    the vorticity step alone (_check_halo_steps)."""
    _check_meshes(spawned, single)
    _check_remat(spawned)
    _check_replicated(spawned)
    _check_counts(spawned)
    _check_halo_steps(spawned)


def _check_meshes(spawned, single):
    """Every schedule on rows meshes of 2 and 4 ranks (box, and the
    channel with 'overlap'), and 'overlap' and 'deep' on 2x2 and 1x4,
    against the single-device
    gradient: forcing within 1e-13, state0.po within 1e-12 (and every
    other field of state0), the value within 1e-12; the forward went
    through the window modes only (no launch: CPU tensors take their
    plain chains)."""
    runs = [(2, i, c) for i, c in enumerate(CASES_2)] + [
        (4, i, c) for i, c in enumerate(CASES_4) if not (c[3] or c[4])]
    for n, i, (kind, shape, variant, _, _) in runs:
        res = spawned[n][0][i]
        val, g = single[kind]
        case = (n, kind, shape, variant)
        assert abs(res["value"] - float(val)) <= VALUE_TOL * abs(
            float(val)), case
        for k, (a, b) in enumerate(zip(res["forcing"], g.forcing)):
            assert rel(a, b) <= FORCING_TOL, (case, k)
        for name, b in g.state0._asdict().items():
            assert rel(res["state0"][name], b) <= STATE_TOL, (case, name)
        assert res["launches"] == dict.fromkeys(("full", "rows", "x_ext"),
                                                0), case


def _check_remat(spawned):
    """remat True (one level of checkpointed pairs), 4 (5 pairs nest in
    two levels), "dots" and host segments of 5 substeps on 4 rows ranks
    against the same mesh's stored one-program gradient, each field
    within 1e-12 of its maximum."""
    res = spawned[4][0]
    stored = res[CASES_4.index(("box", "rows", "overlap", False, 0))]
    for remat, seg in ((True, 0), (4, 0), ("dots", 0), (True, SEGMENT)):
        got = res[CASES_4.index(("box", "rows", "overlap", remat, seg))]
        case = (remat, seg)
        assert abs(got["value"] - stored["value"]) <= \
            REMAT_TOL * abs(stored["value"]), case
        for a, b in zip(got["forcing"], stored["forcing"]):
            assert rel(a, b) <= REMAT_TOL, case
        for name, b in stored["state0"].items():
            assert rel(got["state0"][name], b) <= REMAT_TOL, (case, name)


def _check_replicated(spawned):
    """On every rank of every case the state0 gradient's padding rows
    and columns are zero, and the value and the forcing gradients are
    the same bits as rank 0's."""
    for n in (2, 4):
        for r, rank in enumerate(spawned[n]):
            for i, (res, r0) in enumerate(zip(rank, spawned[n][0])):
                case = (n, r, i)
                assert res["pad_zero"], case
                assert res["value"] == r0["value"], case
                for a, b in zip(res["forcing"], r0["forcing"]):
                    assert np.array_equal(a, b), case


def _check_counts(spawned):
    """Every rank issues the same collectives as rank 0, forward and
    backward, in every case: a rank whose backward issued a collective
    that another's did not would leave it unmatched (the channel on 4
    ranks, whose middle ranks hold no wall row, checks the wall strips).
    Without remat or segments, per collective site the backward issues
    as many collectives as the forward (the site with '.T'); under
    remat=True the forward's count is doubled by the recomputation of
    every pair. The final gather's backward runs once, for the one field
    the loss reads (po), and the gradients' sums are one all_reduce."""
    for n, cases in ((2, CASES_2), (4, CASES_4)):
        for i, case in enumerate(cases):
            counts = spawned[n][0][i]["counts"]
            for r, rank in enumerate(spawned[n][1:], 1):
                assert rank[i]["counts"] == counts, (n, r, case)
            if not (case[3] or case[4]):
                for k in _sites(counts):
                    assert counts[k] == counts[k + ".T"], (n, case, k)
    for remat in (False, True):
        counts = spawned[4][0][CASES_4.index(("box", "rows", "overlap",
                                              remat, 0))]["counts"]
        sites = _sites(counts)
        assert set(sites) >= {"halo.rows", "spectral.a2a", "ocean.oml.rows",
                              "ocean.oml.sums", "ocean.inversion.sums"}, remat
        for k in sites:
            assert counts[k] == (2 if remat else 1) * counts[k + ".T"], \
                (remat, k)
        assert counts["gather.T"] == 1, remat
        assert counts["adjoint.sums"] == 1, remat
        assert "adjoint.sums.T" not in counts, remat


def _sites(counts):
    """The forward's collective sites of a run, but for the final gather
    and the gradients' sums."""
    return [k for k in counts if not k.endswith(".T")
            and k not in ("gather", "adjoint.sums", "test.sums")]


def _single_step_grads(cyclic, sponge, nyaooc):
    cfg = ranks.small_cfg(cyclic, sponge, nyaooc=nyaooc)
    args = list(ranks.halo_args(cfg))
    leaves = [None if a is None else a.clone().requires_grad_()
              for a in args[:7]]
    q = qgstep(*leaves, *args[7:], cyclic=cyclic, sponge=sponge)
    out = (q * ranks.halo_weights(cfg)).sum()
    return torch.autograd.grad(out, [t for t in leaves if t is not None])


def _check_halo_steps(spawned):
    """The gradient of a weighted sum of the vorticity step through
    parallel/halo.py on 4 ranks (the exchanges', the gather's and the
    window kernel's rules) against the single-device step's, every input
    within 1e-12 of its maximum, by schedule; 'local' gathers every
    block, and its backward sums each block's cotangent over the ranks;
    each collective site's backward count equals its forward count."""
    for case, res in zip(HALO_CASES, spawned["halo"]):
        cyclic, sponge, shape, variant, nyaooc = case
        want = _single_step_grads(cyclic, sponge, nyaooc)
        assert len(res["grads"]) == len(want), case
        for a, b in zip(res["grads"], want):
            assert rel(a, b) <= STATE_TOL, case
        counts = res["counts"]
        sites = [k for k in counts if not k.endswith(".T") and k != "test"]
        if variant == "local" or nyaooc == 3:
            assert sites == ["halo.gather"], case
        for k in sites:
            assert counts[k] == counts[k + ".T"], (case, k)


def test_coupled_distributed_gradient_matches_single_device(spawned):
    """The coupled model's distributed adjoint: make_coupled_runner(mesh,
    remat=True, 'overlap', 'a2a') over 2 coupling cycles, the atmosphere
    on row blocks, differentiated for qgcm_tpu's coupled loss (mean(ast^2)
    of the final atmosphere) plus the ocean's layer1_energy_proxy, by
    every field of both initial states, on 4x1 and 2x2 meshes (and on 4
    rows of a taller atmosphere, whose rank 1 holds no row of the wall
    strips), against the port's single-device coupled gradient (remat
    True): every gradient field within 1e-11 of its maximum, the value
    within 1e-12; on every rank the value and the replicated gradients
    (scalars and mode vectors, summed over the ranks) the same bits,
    the blocks' padding zero and the rank's rows of d/d(initial sst)
    nonzero; every rank's collectives, forward and backward, rank 0's;
    each site's backward at most half its forward count (the
    recomputation replays every cycle; the last atmosphere steps' PV
    inversion reaches no loss), exactly half for the ocean's and xforc's
    sites; no launch (CPU tensors take the plain chains)."""
    from qgcm_torch.models.stepper import make_coupled_runner
    res = spawned["coupled"]
    for i, case in enumerate(COUPLED_CASES):
        kind, over, shape = case[:3]
        model, oc, at = ranks.seeded_coupled(kind, **over)
        val, go, ga = ranks.coupled_gradient(
            model, make_coupled_runner(model, remat=True), oc, at,
            CYCLES * model.cfg.nstr)
        got = res[0][i]
        assert abs(got["value"] - float(val)) <= VALUE_TOL * abs(
            float(val)), case
        for name, want in (("ocean", go), ("atmos", ga)):
            for k, b in want._asdict().items():
                assert rel(got[name][k], b) <= COUPLED_TOL, (case, name, k)
        counts = got["counts"]
        for r, rank in enumerate(res):
            mine = rank[i]
            assert mine["value"] == got["value"], (case, r)
            for k, a in got["replicated"].items():
                assert np.array_equal(mine["replicated"][k], a), (case, r, k)
            assert mine["pad_zero"] and mine["sst_rows"], (case, r)
            assert mine["counts"] == counts, (case, r)
        for k in _sites(counts):
            if k + ".T" in counts:
                assert 0 < 2 * counts[k + ".T"] <= counts[k], (case, k)
            if k.startswith(("ocean.", "halo.", "coupling.")):
                assert counts[k] == 2 * counts[k + ".T"], (case, k)
        assert got["launches"] == dict.fromkeys(("full", "rows", "x_ext"),
                                                0), case


def test_matches_qgcm_tpu_distributed_adjoint(spawned):
    """tests/test_adjoint.py:226's call of qgcm_tpu's distributed adjoint
    (4 host devices, a rows mesh, 'overlap', the matmul DST) on the box's
    seeded state, 10 substeps, against the port's on 4 rows ranks: the
    value and every gradient field within 1e-11 of its maximum. qgcm_tpu
    transforms through GSPMD in adjoint runs, the port through its a2a
    pencils."""
    import jax
    import jax.numpy as jnp
    import qgcm_tpu.config
    from qgcm_tpu.adjoint import layer1_energy_proxy, ocean_sensitivity as \
        jax_sensitivity
    from qgcm_tpu.model import build_model
    from qgcm_tpu.parallel.mesh import make_mesh, shard_tree
    from qgcm_tpu.state import OceanState
    from test_torch_cases import quick_compile, to_jax

    cfg = ranks.small_cfg(cfgmod=qgcm_tpu.config).replace(
        solver_transform="matmul").validate()
    model = build_model(cfg)
    _, st0, mf, _ = ranks.adjoint_setup("box")
    mf = tuple(jnp.asarray(a.numpy()) for a in mf)
    mesh = make_mesh(jax.devices()[:4], rows_only=True)
    fn = jax.jit(jax_sensitivity(model, layer1_energy_proxy(model),
                                 remat=False, jit=False, mesh=mesh,
                                 halo_variant="overlap"),
                 static_argnames=("n_steps",))
    s0 = shard_tree(to_jax(OceanState, st0), mesh)
    val, g = quick_compile(fn, s0, mf, STEPS)(s0, mf)
    res = spawned[4][0][CASES_4.index(("box", "rows", "overlap", False, 0))]
    assert abs(res["value"] - float(val)) <= JAX_TOL * abs(float(val))
    for i, (a, b) in enumerate(zip(res["forcing"], g.forcing)):
        assert rel(a, b) <= JAX_TOL, i
    for name, b in g.state0._asdict().items():
        assert rel(res["state0"][name], b) <= JAX_TOL, name
