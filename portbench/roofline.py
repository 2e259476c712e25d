"""The yardstick's counts: the card's peaks, and the least work of the
vorticity kernel and of a whole ocean substep, from the shapes alone.

The peaks are NVIDIA's H100 SXM data sheet's, at the full 700 W (the
power limit is printed beside every run). The kernel's bound is a copy
of the one chip_smoke.py has used since the kernel was written
(kernel_bound): each input read once and the output written once at the
memory rate, or the counted operations at the float rate. The
substep's bound counts what any implementation of the substep has to
move and compute, whatever its kernels:

  bytes, per member: the four prognostic 3-D fields (po, pom, qo, qom)
    read once, the new q and p written once; the mixed layer's two SST
    levels read once and the new SST written once. Shared by all
    members: the forcing planes (tauxo, tauyo, wekpo on the p grid;
    wekto, fnetoc on the T grid) read once.
  operations, per member: the kernel's FLOP_PER_POINT at every point of
    every layer and FLOP_PER_COLUMN at every point, and 2.5 N log2 N for
    each real DST-I line of length N of the solve (a forward and an
    inverse 2-D transform of every layer).

The averaging every 25th substep and the mixed layer's arithmetic are
left out, so the bound is never above the work that has to be done.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "float64": 34e12}
ITEM_BYTES = {"float32": 4, "float64": 8}

# operations of the fused vorticity step at an interior point (three
# 5-point Laplacians, 6 each; the Jacobian, 31; dq/dt, 5; the update,
# 2) in every layer, and the forcing of layers 0, 1 and nl-1 (7 a
# column in all)
FLOP_PER_POINT = 56
FLOP_PER_COLUMN = 7
# the k247 sponge's operations a point
SPONGE_FLOP_PER_POINT = 4


def _bound(nbytes: float, flop: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(nl: int, ny: int, nx: int, dtype: str, sponge: bool = False,
                 members: int = 1, shared_planes: int = 0) -> tuple:
    """(bound_ms, bound_by) of one launch of the fused vorticity step for
    `members` members: pom, po, qo, qom read once, the planes wekpo and
    entoc (and the sponge's r_spl) read once, qnew written once; of the
    planes, `shared_planes` are one copy that every member reads."""
    planes = 3 if sponge else 2
    nbytes = ITEM_BYTES[dtype] * ny * nx * (
        members * (5 * nl + planes - shared_planes) + shared_planes)
    flop = members * (nl * ny * nx * (FLOP_PER_POINT + (
        SPONGE_FLOP_PER_POINT if sponge else 0)) + FLOP_PER_COLUMN * ny * nx)
    return _bound(nbytes, flop, dtype)


def substep_bytes(nl: int, nyp: int, nxp: int, nyt: int, nxt: int,
                  dtype: str, members: int = 1) -> float:
    """Bytes a box substep has to move (the module's docstring)."""
    p, t = nyp * nxp, nyt * nxt
    return ITEM_BYTES[dtype] * (members * (6 * nl * p + 3 * t)
                                + 3 * p + 2 * t)


def dst_flop(n: int) -> float:
    """Operations of one real DST-I of length n."""
    return 2.5 * n * math.log2(n)


def substep_flop(nl: int, nyp: int, nxp: int, members: int = 1) -> float:
    """Operations a box substep has to do (the module's docstring)."""
    ny, nx = nyp - 2, nxp - 2
    solve = 2 * nl * (ny * dst_flop(nx) + nx * dst_flop(ny))
    step = nl * nyp * nxp * FLOP_PER_POINT + FLOP_PER_COLUMN * nyp * nxp
    return members * (step + solve)


def substep_bound(nl: int, nyp: int, nxp: int, nyt: int, nxt: int,
                  dtype: str, members: int = 1) -> tuple:
    """(bound_ms, bound_by) of one box substep of `members` members."""
    return _bound(substep_bytes(nl, nyp, nxp, nyt, nxt, dtype, members),
                  substep_flop(nl, nyp, nxp, members), dtype)
