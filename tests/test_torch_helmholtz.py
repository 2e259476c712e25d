"""qgcm_torch's box Helmholtz solver against qgcm_tpu's and against the
host-side float64 NumPy solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgcm_tpu.solver import helmholtz as J_h
from qgcm_torch.solver import helmholtz as T_h

from test_torch_cases import rel_err

RDM2 = np.array([0.0, 2.3e-10, 9.1e-10])


@pytest.mark.parametrize("dim", [-1, -2, 0])
def test_dst1(dim):
    x = np.random.default_rng(7).standard_normal((3, 17, 30))
    got = T_h.dst1(torch.from_numpy(x), dim=dim)
    assert rel_err(got, J_h.dst1(jnp.asarray(x), axis=dim)) <= 1e-13
    assert rel_err(got, J_h.dst1_np(x, axis=dim)) <= 1e-13
    assert np.array_equal(T_h.dst1_np(x, axis=dim), J_h.dst1_np(x, axis=dim))
    # dst1(dst1(x)) == 2(N+1) x
    n = x.shape[dim]
    back = T_h.dst1(got, dim=dim) / (2 * (n + 1))
    assert rel_err(back, x) <= 1e-13


@pytest.mark.parametrize("shape", [(33, 17), (41, 52)])
def test_box_solve(shape):
    nxp, nyp = shape
    dx = dy = 20e3
    rhs = np.random.default_rng(8).standard_normal((3, nyp, nxp)) * 1e-9
    th = T_h.make_box_helmholtz(nxp, nyp, dx, dy, RDM2, device="cpu")
    jh = J_h.make_box_helmholtz(nxp, nyp, dx, dy, RDM2)
    got = th.solve(torch.from_numpy(rhs))
    assert got.shape == rhs.shape
    assert rel_err(got, th.solve_np(rhs)) <= 1e-12
    assert rel_err(got, jh.solve(jnp.asarray(rhs))) <= 1e-12
    assert np.array_equal(th.solve_np(rhs), jh.solve_np(rhs))
    # Dirichlet walls, and the 5-point operator inverts the solve
    g = got.numpy()
    assert not g[:, [0, -1], :].any() and not g[:, :, [0, -1]].any()
    lap = (g[:, :-2, 1:-1] + g[:, 2:, 1:-1] + g[:, 1:-1, :-2]
           + g[:, 1:-1, 2:] - 4.0 * g[:, 1:-1, 1:-1]) / dx**2
    resid = lap - RDM2[:, None, None] * g[:, 1:-1, 1:-1]
    assert rel_err(resid, rhs[:, 1:-1, 1:-1]) <= 1e-10


def test_solve_np_needs_a_float64_solver():
    th = T_h.make_box_helmholtz(33, 17, 20e3, 20e3, RDM2,
                                dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="float64"):
        th.solve_np(np.ones((3, 17, 33)))
