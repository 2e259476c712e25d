"""solve_ms: device milliseconds of one substep's PV solve, the forward
and the inverse 2-D transform of BoxHelmholtz at the cell's shapes and
member batching, timed by CUDA events over REPS calls after WARMUP."""

import torch

WARMUP = 3
REPS = 20


def collect(ctx):
    helm = getattr(ctx.model.inv_oc, "helm", None)
    if ctx.device.type != "cuda" or not hasattr(helm, "forward"):
        return {}
    cfg = ctx.model.cfg
    shape = (cfg.nlo, cfg.nypo, cfg.nxpo)
    if ctx.members > 1:
        shape = (ctx.members,) + shape
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    x = torch.randn(shape, generator=gen, dtype=ctx.model.dtype,
                    device=ctx.device)
    for _ in range(WARMUP):
        helm.inverse(helm.forward(x))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        helm.inverse(helm.forward(x))
    b.record()
    b.synchronize()
    return {"solve_ms": a.elapsed_time(b) / REPS}


def read(record):
    if not record.get("on_card"):
        return None
    return record.get("solve_ms")
