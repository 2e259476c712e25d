"""Time stepping of the ocean-only model (port of
qgcm_tpu/models/stepper.py).

Leapfrog computational-mode suppression (q-gcm.F:1325-1366): the
current time level is averaged with the lagged one, x <- (x + xm)/2,
after every ocean substep whose 0-based index n has n % 25 == 0. NOT a
Robert-Asselin filter: the lagged level is left as it is, exactly as
the reference does.
"""

from __future__ import annotations

from ..model import Model
from ..state import OceanState, OceanForcing
from .ocean import make_ocean_step

OCEAN_AVG_PERIOD = 25   # ocean substeps between time-level averagings


def average_ocean_levels(st: OceanState) -> OceanState:
    """x <- (x + xm)/2 for the current time level only
    (q-gcm.F:1328-1366, constraint variables included)."""
    return st._replace(
        po=0.5 * (st.po + st.pom),
        qo=0.5 * (st.qo + st.qom),
        sst=0.5 * (st.sst + st.sstm),
        dpioc=0.5 * (st.dpioc + st.dpiocp),
        ocncs=0.5 * (st.ocncs + st.ocncsp),
        ocncn=0.5 * (st.ocncn + st.ocncnp),
    )


def make_ocean_only_runner(model: Model):
    """Returns run(state, forcing, n_steps, step0=0) -> state.

    `step0` is the 0-based index of the first ocean substep taken by
    this call, so chunked host loops keep the averaging cadence aligned.
    The loop is plain Python over single substeps; PyTorch runs each
    substep's operations eagerly on the model's device."""
    step = make_ocean_step(model)

    def run(state: OceanState, forcing: OceanForcing, n_steps: int,
            step0: int = 0) -> OceanState:
        for n in range(step0, step0 + n_steps):
            state, _diags = step(state, forcing)
            if n % OCEAN_AVG_PERIOD == 0:
                state = average_ocean_levels(state)
        return state

    return run
