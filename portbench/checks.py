"""What decides `correct`: the program's states against the plain
reference that the configuration names (portbench/reference/), each
reading beside its limit.

Readings, each the largest over the members, every member held to its
own reference (so members that trade places fail):
  start     the state after the first chunk, which set-up runs through
            the window's own runner from the seeded inputs, against the
            float64 reference run from the same inputs: po, qo and SST,
            each as its largest gap over the reference's largest value
            (qo: of the reference's qo less beta*y)
  final     the program's last state, after the window (and a --trace 1
            run's traced chunks), against the same float64 reference
            followed from the inputs over every substep the program
            stepped: the same fields and scales
  launches  one full-field kernel launch a substep and every member
            stepped by it: |launches - substeps| + |members stepped -
            substeps * members| (CUDA runs only)
"""

from __future__ import annotations

import math

import torch

# the fields compared, with qo measured against |qo - beta*y|
COMPARED = ("po", "qo", "sst")


def _rel(gap: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per member: the largest |gap| over the largest |scale|."""
    dims = tuple(range(1, gap.dim()))
    num = gap.abs().amax(dim=dims)
    den = scale.abs().amax(dim=dims)
    return torch.where(den > 0, num / den, num)


def state_gaps(ref, prog: dict, want: dict) -> torch.Tensor:
    """(M,) the largest relative gap of po, qo and SST of the program's
    state `prog` from the reference's `want` (a NaN reads as inf)."""
    gaps = []
    for k in COMPARED:
        p = ref.cast(prog[k])
        scale = want[k] - ref.betay if k == "qo" else want[k]
        gaps.append(_rel(p - want[k], scale))
    g = torch.stack(gaps).amax(dim=0)
    return torch.where(torch.isnan(g), math.inf, g)


def judge(readings: dict, limits: dict) -> tuple:
    """({name: {"value": reading, "limit": limit}}, whether every reading
    is within its limit). A reading with no limit, or a limit with no
    reading, fails."""
    out = {k: {"value": readings.get(k), "limit": limits.get(k)}
           for k in dict.fromkeys([*readings, *limits])}
    ok = all(v["value"] is not None and v["limit"] is not None
             and math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return out, ok
