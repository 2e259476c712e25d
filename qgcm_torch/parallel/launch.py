"""Starting and ending a process group (port of
qgcm_tpu/parallel/launch.py).

The reference runs one process of 32 OpenMP threads over grid rows
(src/cntl_q-gcm); qgcm_tpu runs one controller per host over a device
mesh. Here each rank is one process with one block of rows (see
parallel/mesh.py), joined by torch.distributed:

    # one host, four cards, NCCL:
    torchrun --nproc-per-node 4 my_run.py

    # my_run.py
    from qgcm_torch.parallel.launch import distributed_session
    from qgcm_torch.parallel.mesh import make_mesh, shard_tree
    with distributed_session("nccl"):
        mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
        ...

or, without torchrun, `spawn_ranks(fn, n, backend=..., workdir=...)`,
which starts n processes on this host and hands each result back. The
backend is the caller's choice: "nccl" for one card per rank, "gloo"
for the CPU or for ranks that share one card (the mesh then stages CUDA
tensors through host memory). Nothing switches from one backend to the
other when one fails to start.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@contextlib.contextmanager
def distributed_session(backend=None, init_method=None, world_size=None,
                        rank=None, timeout=None):
    """Initialise the default process group, and destroy it on exit.

    Without arguments and outside torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) this is a no-op, so that one
    driver serves one process and many. Otherwise `backend` ("nccl" or
    "gloo") must be given; `init_method` defaults to torchrun's "env://";
    `timeout` (seconds) bounds each collective (the backend's default
    otherwise).
    With NCCL each rank takes the card of its local rank (LOCAL_RANK,
    else its rank) as its current device. A backend that fails to start
    raises."""
    in_env = all(k in os.environ for k in _TORCHRUN_ENV)
    if world_size is None and init_method is None and not in_env:
        yield
        return
    if backend is None:
        raise ValueError("name the process group's backend: 'nccl' or "
                         "'gloo'")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local)
    # torchrun's environment gives the rank and size where they are not
    # passed
    kw = {k: v for k, v in (("world_size", world_size), ("rank", rank))
          if v is not None}
    if timeout is not None:
        kw["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that owns global (not per-block) I/O: rank 0,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank, nprocs, fn, args, backend, workdir, timeout):
    init = Path(workdir, "rendezvous").resolve().as_uri()
    with distributed_session(backend, init_method=init, world_size=nprocs,
                             rank=rank, timeout=timeout):
        out = fn(*args)
        dist.barrier()
    torch.save(out, Path(workdir, f"rank{rank}.pt"))


def spawn_ranks(fn, nprocs: int, *args, backend: str, workdir,
                timeout=None) -> list:
    """Run fn(*args) in `nprocs` new processes (the "spawn" start
    method), rank r inside distributed_session(backend) with a file
    rendezvous in `workdir`, which must exist and hold no earlier
    rendezvous file. Returns the ranks' results in rank order, passed
    back through torch.save files in `workdir`. `fn` must be importable
    by name (a module-level function) and its module, like this one,
    must not import what the ranks should not load. `timeout` is
    distributed_session's. A rank that raises makes this raise."""
    import torch.multiprocessing as mp
    workdir = Path(workdir)
    if (workdir / "rendezvous").exists():
        raise FileExistsError(f"{workdir / 'rendezvous'} exists; use a new "
                              "directory")
    mp.start_processes(_rank_main, args=(nprocs, fn, args, backend,
                                         str(workdir), timeout),
                       nprocs=nprocs, join=True, start_method="spawn")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]
