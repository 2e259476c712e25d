"""Area integrals with C-grid edge weights (port of
qgcm_tpu/ops/integrals.py).

xintt is the plain T-grid sum and xintp the p-grid trapezoidal sum
with 1/2 edge and 1/4 corner weights (reference src/intsubs.f); multiply by dx*dy for the physical
area integral, as the reference's call sites do. line_sum is its
one-dimensional form along a boundary row. xintp_block is one block's
share of xintp in a decomposed run (parallel/mesh.py): the edges' half
weights fall on the blocks that hold them, by global row and column; a
row block holds every column, and its share keeps line_sum's form.
"""

from __future__ import annotations

import numpy as np
import torch


def xintp_weights(nyp: int, nxp: int, dtype=np.float64) -> np.ndarray:
    """Trapezoidal p-grid weights: 1 interior, 1/2 edges, 1/4 corners."""
    w = np.ones((nyp, nxp), dtype=dtype)
    w[0, :] *= 0.5
    w[-1, :] *= 0.5
    w[:, 0] *= 0.5
    w[:, -1] *= 0.5
    return w


def line_sum(row: torch.Tensor, dtype=None) -> torch.Tensor:
    """Sum along a p-grid row with 1/2 weights at the two ends (the
    reference's 0.5*f(1) + sum + 0.5*f(nxp) pattern), accumulated in
    `dtype` (default: the row's)."""
    t = dtype or row.dtype
    return (row[..., 1:-1].sum(-1, dtype=dtype)
            + 0.5 * (row[..., 0].to(t) + row[..., -1].to(t)))


def xintp(field: torch.Tensor, dtype=None) -> torch.Tensor:
    """Trapezoidal p-grid sum over the last two axes, from slices (no
    grid-sized weight field), accumulated in `dtype` (default: the
    field's)."""
    inner = field[..., 1:-1, 1:-1].sum(dim=(-2, -1), dtype=dtype)
    edges = 0.5 * (field[..., 0, 1:-1].sum(dim=-1, dtype=dtype)
                   + field[..., -1, 1:-1].sum(dim=-1, dtype=dtype)
                   + field[..., 1:-1, 0].sum(dim=-1, dtype=dtype)
                   + field[..., 1:-1, -1].sum(dim=-1, dtype=dtype))
    corners = 0.25 * (field[..., 0, 0] + field[..., 0, -1]
                      + field[..., -1, 0] + field[..., -1, -1])
    return inner + edges + corners.to(dtype or field.dtype)


def xintt(field: torch.Tensor, dtype=None) -> torch.Tensor:
    """Plain T-grid sum over the last two axes, accumulated in `dtype`
    (default: the field's)."""
    return field.sum(dim=(-2, -1), dtype=dtype)


def edge_weights(g0: int, n: int, size: int, device) -> torch.Tensor:
    """The trapezoid's weights of the indices g0 .. g0+n-1 of an axis of
    `size` points: 1/2 at its two ends, 0 past them (padding)."""
    g = g0 + torch.arange(n, device=device)
    return torch.where((g == 0) | (g == size - 1), 0.5, 1.0) * (g < size)


def xintp_block(field: torch.Tensor, r0: int, ny: int, c0: int = 0,
                nx: int = None, dtype=None) -> torch.Tensor:
    """This block's share of xintp(field): `field` holds rows r0, r0+1,
    ... of a grid ny rows tall and, with `nx`, columns c0, c0+1, ... of
    its nx (rows and columns past the grid's end are padding and weigh
    nothing); without `nx` the block has every column. The shares of all
    blocks sum to xintp."""
    t = dtype or field.dtype
    wy = edge_weights(r0, field.shape[-2], ny, field.device).to(t)
    if nx is None:
        return (line_sum(field, dtype=dtype) * wy).sum(-1)
    wx = edge_weights(c0, field.shape[-1], nx, field.device).to(t)
    return ((field.to(t) * wx).sum(-1) * wy).sum(-1)
