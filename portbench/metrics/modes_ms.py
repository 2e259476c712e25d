"""modes_ms: device milliseconds of one substep's layer <-> mode
products (the port's ops/modes.py::modes, the PV inversion's layers to
modes and back): a pair of calls, layers to modes then modes to layers,
at the cell's shapes, member batching (one call under vmap for all
members) and type, timed by CUDA events over REPS pairs after WARMUP,
times the calls a substep makes. That count is the run's `modes.launches`
(from the process's start: set-up makes none before its first substep)
over its full-field kernel launches (one a substep from set-up's first
chunk on, as the output check's `launches` holds them). A program
without the function collects nothing."""

import torch

WARMUP = 3
REPS = 20


def collect(ctx):
    if ctx.device.type != "cuda":
        return {}
    try:
        from qgcm_torch.ops.modes import modes
    except ImportError:
        return {}
    from qgcm_torch.ops.qgstep import qgstep
    if not qgstep.launches:
        return {}
    calls = modes.launches / qgstep.launches
    model, cfg = ctx.model, ctx.model.cfg
    shape = (cfg.nlo, cfg.nypo, cfg.nxpo)
    if ctx.members > 1:
        shape = (ctx.members,) + shape
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    x = torch.randn(shape, generator=gen, dtype=model.dtype,
                    device=ctx.device)

    def pair(v):
        return modes(model.cm2l, modes(model.cl2m, v))
    if ctx.members > 1:
        pair = torch.func.vmap(pair)
    for _ in range(WARMUP):
        pair(x)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        pair(x)
    b.record()
    b.synchronize()
    return {"modes_ms": a.elapsed_time(b) / REPS / 2 * calls}


def read(record):
    if not record.get("on_card"):
        return None
    return record.get("modes_ms")
