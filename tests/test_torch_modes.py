"""The inversions' layer <-> mode products (qgcm_torch/ops/modes.py): the
einsums they replaced in models/ocean.py, bit for bit in float32 and
float64, plainly and under torch.func.vmap, and their count and spans a
substep of the box and of the channel."""

import numpy as np
import pytest
import torch

from qgcm_torch import config as C
from qgcm_torch.generators import eddy_pressure, zero_forcing
from qgcm_torch.model import build_model
from qgcm_torch.models.ocean import init_ocean_state, ocean_forcing_from_mean
from qgcm_torch.models.stepper import make_ocean_only_runner
from qgcm_torch.ops import modes as M

# the einsums of models/ocean.py that modes() replaced: layers to modes
# (_ocinvq's PV), modes to layers (_ocinvq's and _channel_pressure's)
REPLACED = ("mk,kyx->myx", "km,myx->kyx")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def bits(t):
    kind = torch.int32 if t.dtype == torch.float32 else torch.int64
    return t.contiguous().view(kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("eq", REPLACED)
@pytest.mark.parametrize("vmapped", [False, True])
def test_modes_is_the_einsum_bit_for_bit(dtype, eq, vmapped):
    mat = seeded((3, 3), dtype, 1)
    x = seeded((4, 3, 17, 23) if vmapped else (3, 17, 23), dtype, 2)
    # a strided operand, as the channel's sol[..., :-1] is
    x = x[..., :-1]

    def want(v):
        return torch.einsum(eq, mat, v)

    def got(v):
        return M.modes(mat, v)

    M.reset_launches()
    if vmapped:
        want, got = torch.func.vmap(want), torch.func.vmap(got)
    a, b = got(x), want(x)
    assert M.modes.launches == 1
    assert a.shape == b.shape and a.dtype == dtype
    assert torch.equal(bits(a), bits(b))


def substep_calls(cfg, steps):
    """The products' calls in `steps` substeps, and their spans in a
    profile of them."""
    model = build_model(cfg, "cpu")
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)
    M.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run(st, f, steps)
    spans = sum(e.count for e in prof.key_averages()
                if e.key == "qgcm_torch::modes")
    return M.modes.launches, spans


@pytest.mark.parametrize("cfg", [
    C.double_gyre_ocean_only(nxta=16, nyta=16, nxaooc=8, nyaooc=8, ndxr=3,
                             dta=200.0),
    C.southern_ocean_ocean_only(nxta=16, nyta=8, nxaooc=16, nyaooc=4,
                                ndxr=3, dta=200.0)],
    ids=["box", "channel"])
def test_a_substep_counts_its_products(cfg):
    # layers to modes and back: two a substep in the box and in the
    # channel, whose modes to layers is _channel_pressure's
    assert substep_calls(cfg, 1) == (2, 2)
    assert substep_calls(cfg, 3) == (6, 6)
