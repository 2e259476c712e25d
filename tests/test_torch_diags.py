"""The port's diagnostics against qgcm_tpu's, function by function, in
float64 on the CPU: the same seeded states go through both packages
(carried across by qgcm_torch.convert) and every output is held at
1e-12 of its largest magnitude. Configurations: the tiny ocean-only
box, the coupled channel with nb_hflux and the coupled double gyre (the
sizes of tests/test_torch_coupled.py)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qgcm_tpu.diags.areas as j_areas
import qgcm_tpu.diags.covaria as j_cov
import qgcm_tpu.diags.timavge as j_tav
from qgcm_tpu.diags.cfl import cfl_numbers as jax_cfl
from qgcm_tpu.diags.monitor import compute_monitor as jax_monitor
from qgcm_tpu.diags.qocdiag import qocdiag_terms as jax_qocdiag
from qgcm_tpu.diags.valids import post_mortem as jax_post_mortem
from qgcm_tpu.diags.valids import valids as jax_valids
from qgcm_tpu.models.ocean import _oml as jax_oml
import qgcm_torch.diags.areas as t_areas
import qgcm_torch.diags.covaria as t_cov
import qgcm_torch.diags.timavge as t_tav
from qgcm_torch.convert import atmos_state_to_torch, state_to_torch
from qgcm_torch.diags.cfl import cfl_numbers
from qgcm_torch.diags.monitor import compute_monitor, monitor_values
from qgcm_torch.diags.qocdiag import qocdiag_terms
from qgcm_torch.diags.valids import post_mortem, valids
from qgcm_torch.models.ocean import _oml

from test_torch_cases import (StepDiags, assert_match, get_case,
                              one_torch_thread, quick_compile, writable)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

KINDS = ["box", "channel-nb_hflux", "coupled"]


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    return get_case(request.param)


def ocean_samples(oc):
    """Two ocean states to accumulate: the case's, and one shifted."""
    return oc, oc._replace(sst=oc.sst + 0.5, po=1.1 * oc.po)


def atmos_samples(at):
    return at, at._replace(ast=at.ast + 1.0, pa=1.1 * at.pa)


@functools.lru_cache(maxsize=None)
def jax_outputs(kind):
    """qgcm_tpu's outputs on a case, from one jitted program (one compile
    instead of one for each function): the validity and CFL reports, the
    monitor record, the dq/dt terms, and two accumulations of each
    fluid's running means."""
    c = get_case(kind)
    jm = c.jm
    diags = StepDiags(*map(jnp.asarray, c.np_diags))

    def outputs(oc, at, ofor, afor, xd):
        out = dict(valids=jax_valids(jm, oc, at, ofor, afor),
                   cfl=jax_cfl(jm, oc, at, ofor, afor),
                   monitor=jax_monitor(jm, oc, at, ofor, afor, diags, diags,
                                       xd),
                   qocdiag=jax_qocdiag(jm, oc, ofor,
                                       jax_oml(jm, oc, ofor)[2]))
        oacc = j_tav.zero_ocean_averages(jm.cfg, jnp.float64)
        for st in ocean_samples(oc):
            oacc = j_tav.accumulate_ocean(oacc, st, ofor, jm)
        out["oacc"] = oacc
        if at is not None:
            aacc = j_tav.zero_atmos_averages(jm.cfg, jnp.float64)
            for st in atmos_samples(at):
                aacc = j_tav.accumulate_atmos(aacc, st, afor, jm)
            out["aacc"] = aacc
        return out
    args = (*c.jax_args(), c.jax_xd)
    return quick_compile(jax.jit(outputs), *args)(*args)


def test_valids_match_jax(case):
    assert_match(valids(case.model, *case.args()),
                 jax_outputs(case.kind)["valids"])


def test_valids_flags_a_blowup():
    """A NaN and an out-of-range value each fail the scan in both."""
    c = get_case("coupled")
    for field, val in (("po", np.nan), ("qo", 1.0)):
        arr = writable(c.jax_oc)
        arr[field][1, 3, 4] = val
        oc_j = type(c.jax_oc)(**{k: jnp.asarray(v) for k, v in arr.items()})
        oc_t = state_to_torch(arr, "cpu")
        rep_t = valids(c.model, oc_t, c.at, c.ofor, c.afor)
        rep_j = jax_valids(c.jm, oc_j, c.jax_at, c.jax_ofor, c.jax_afor)
        assert not bool(rep_t.ok) and not bool(rep_j.ok)


def test_cfl_matches_jax(case):
    assert_match(cfl_numbers(case.model, *case.args()),
                 jax_outputs(case.kind)["cfl"])


def test_monitor_matches_jax(case):
    """Every field of MonitorRecord (the cfl and boundary-flux records
    and the xforc means included). The area means of entrainment and
    Ekman velocity (entm, wetm, wepm) can be zero by construction (the
    mixed layer removes the mean entrainment; the curl of a stress that
    vanishes on the walls integrates to zero), leaving roundoff: each is
    held at 1e-12 of its companion mean magnitude (enam, watm, wapm)."""
    d = case.np_diags
    got = compute_monitor(case.model, *case.args(),
                          odiags=StepDiags(*map(torch.tensor, d)),
                          adiags=StepDiags(*map(torch.tensor, d)),
                          xdiags=case.xd)
    want = jax_outputs(case.kind)["monitor"]
    scale = {f"{fl}.{m}": float(getattr(getattr(want, fl), a))
             for fl in ("oc", "at") if getattr(want, fl) is not None
             for m, a in (("entm", "enam"), ("wetm", "watm"),
                          ("wepm", "wapm"))}
    # the mean interface displacement is a small difference of large
    # ones: held at 1e-12 of its RMS, sqrt(et2m)
    for fl in ("oc", "at"):
        if getattr(want, fl) is not None:
            scale[f"{fl}.etam"] = float(np.sqrt(np.max(
                getattr(want, fl).et2m)))
    assert_match(got, want, scale=scale)
    # monit.nc's 51 (ocean-only) or 96 (coupled) variables, less time
    # and the layer-depth coordinates
    names = monitor_values(got)
    assert len(names) == (51 - 3 if case.cfg.ocean_only else 96 - 5)


def test_time_averages_match_jax(case):
    """Two accumulations of each fluid's running means, then the eddy
    heat fluxes <uT> - <u><T>."""
    want = jax_outputs(case.kind)
    oacc = t_tav.zero_ocean_averages(case.model)
    for st in ocean_samples(case.oc):
        oacc = t_tav.accumulate_ocean(oacc, st, case.ofor, case.model)
    assert_match(oacc, want["oacc"])
    assert_match(t_tav.eddy_fluxes(oacc), j_tav.eddy_fluxes(want["oacc"]))
    if case.at is not None:
        aacc = t_tav.zero_atmos_averages(case.model)
        for st in atmos_samples(case.at):
            aacc = t_tav.accumulate_atmos(aacc, st, case.afor, case.model)
        assert_match(aacc, want["aacc"])
        assert_match(t_tav.eddy_fluxes(aacc),
                     j_tav.eddy_fluxes(want["aacc"]))


def test_qocdiag_terms_match_jax(case):
    entoc = _oml(case.model, case.oc, case.ofor)[2]
    assert_match(qocdiag_terms(case.model, case.oc, case.ofor, entoc),
                 jax_outputs(case.kind)["qocdiag"])


@pytest.mark.parametrize("grid,nsi", [("p", 2), ("t", 2), ("t", 1)])
def test_covariance_matches_jax(grid, nsi):
    """Three samples of a seeded field through accumulate_cov, then the
    packed SSP, mean and weight sum of finalize_cov."""
    c = get_case("coupled")
    rng = np.random.default_rng(3)
    shape = ((c.cfg.nypo, c.cfg.nxpo) if grid == "p"
             else (c.cfg.nyto, c.cfg.nxto))
    nv = t_cov.cov_size(*shape, nsi, grid=grid)
    assert nv == j_cov.cov_size(*shape, nsi, grid=grid)
    acc_t, acc_j = t_cov.zero_cov(nv), j_cov.zero_cov(nv)
    step_j = jax.jit(functools.partial(j_cov.accumulate_cov, nsi=nsi,
                                       grid=grid))
    for _ in range(3):
        f = 10.0 + rng.standard_normal(shape)
        acc_t = t_cov.accumulate_cov(acc_t, torch.tensor(f), nsi, grid)
        acc_j = step_j(acc_j, jnp.asarray(f))
    assert_match(t_cov.finalize_cov(acc_t), j_cov.finalize_cov(acc_j))


def test_covariance_row_blocks(monkeypatch):
    """The packed update in row blocks equals one dense outer product."""
    d = torch.tensor(np.random.default_rng(4).standard_normal(37))
    monkeypatch.setattr(t_cov, "_BLOCK", 50)
    got = t_cov._add_packed_outer(torch.zeros(37 * 38 // 2,
                                              dtype=torch.float64), d)
    i, j = np.tril_indices(37)
    assert np.array_equal(got.numpy(), d.numpy()[i] * d.numpy()[j])


def test_unpack_cov_matches_jax():
    """A finalized packed SSP of seeded samples unpacked to its dense
    symmetric matrix, against qgcm_tpu's unpack_cov of the same array;
    the dense matrix is the samples' corrected sum of products."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 23))
    acc = t_cov.zero_cov(23)
    for row in x:
        acc = t_cov.accumulate_cov(acc, torch.tensor(row[None, :]), 1)
    _, packed, _ = t_cov.finalize_cov(acc)
    got = t_cov.unpack_cov(packed, 23)
    assert np.array_equal(got, j_cov.unpack_cov(packed, 23))
    assert np.array_equal(got, got.T)
    d = x - x.mean(axis=0)
    np.testing.assert_allclose(got, d.T @ d, rtol=0, atol=1e-12)


def test_area_averages_match_jax(tmp_path):
    c = get_case("coupled")
    limits = tmp_path / "areas.limits"
    limits.write_text(
        "   2                 !!nareoc\n"
        "   0.0d3  100.0d3    !!xlooc\n"
        " 300.0d3  260.0d3    !!xhioc\n"
        "   0.0d3   50.0d3    !!ylooc\n"
        " 300.0d3  250.0d3    !!yhioc\n"
        "   oc1      oc2      !!areaoc\n"
        "   1                 !!nareat\n"
        "   0.0d3             !!xloat\n"
        " 1000.0d3            !!xhiat\n"
        "   0.0d3             !!yloat\n"
        "  900.0d3            !!yhiat\n"
        "   at1               !!areaat\n")
    bt = t_areas.build_area_boxes(c.model, str(limits))
    bj = j_areas.build_area_boxes(c.jm, str(limits))
    assert_match(t_areas.area_averages(bt, c.oc.sst, c.at.ast),
                  j_areas.area_averages(bj, c.jax_oc.sst, c.jax_at.ast))


def test_post_mortem_names_the_same_points():
    """On a blown-up state (a NaN in qo, a spike in po, a storm in pa)
    the port's post-mortem report is qgcm_tpu's, character for
    character: the same k, j, i of every field's extremum and the same
    neighbourhoods."""
    c = get_case("coupled")
    oc, at = writable(c.jax_oc), writable(c.jax_at)
    oc["qo"][2, 5, 7] = np.nan
    oc["po"][1, 0, 3] = 3.0e4
    at["pa"][0, 6, 11] = -2.0e7
    oc_j = type(c.jax_oc)(**{k: jnp.asarray(v) for k, v in oc.items()})
    at_j = type(c.jax_at)(**{k: jnp.asarray(v) for k, v in at.items()})
    got = post_mortem(c.model, state_to_torch(oc, "cpu"),
                      atmos_state_to_torch(at, "cpu"), c.ofor, c.afor)
    want = jax_post_mortem(c.jm, oc_j, at_j, c.jax_ofor, c.jax_afor)
    where = re.compile(r"(\w+) = \S+ located at k, j, i = (\d+ \d+ \d+)")
    assert dict(where.findall(got))["qo"] == "2 5 7"
    assert where.findall(got) == where.findall(want)
    assert got == want
