"""Joining a ``torch.distributed`` job, and local worlds of processes.

Counterpart of ``labrador_tpu/parallel/multihost.py``.  Usage on each
rank of a job started by ``torchrun``:

    from labrador_tpu_torch.parallel import multihost
    multihost.initialize(backend="nccl")      # from torchrun's environment
    mesh = multihost.global_mesh(n_dp=2)      # every rank of the job
    fn = make_sharded_prover(params, mesh)    # parallel/sharded.py

A process that no launcher started (no RANK / WORLD_SIZE in its
environment) and names no job joins a world of its own, one rank on a
local store, so the same code runs unsharded.  ``spawn_local`` starts a
world of processes on this host (each rank on the CPU or sharing one
card over gloo): the tests, ``chip_smoke.py`` and
``benchmarks/sharded_scaling.py`` use it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, make_mesh


def initialize(backend: str, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout: datetime.timedelta | None = None) -> None:
    """Initialize ``torch.distributed`` once per process, over ``backend``,
    which the caller chooses: ``nccl`` when each rank has its own card,
    ``gloo`` when ranks share one card or run on the CPU.

    * Already initialized: nothing to do.
    * ``init_method`` given (a ``tcp://`` or ``file://`` address, with
      ``world_size`` and ``rank``): join that job, and raise if joining
      fails, as the JAX package does for an explicitly configured job.
    * RANK and WORLD_SIZE in the environment (``torchrun``, with
      MASTER_ADDR / MASTER_PORT): join through ``env://``; a failure
      raises too.
    * Otherwise a world of this one process on a local store."""
    if dist.is_initialized():
        return
    kw = {} if timeout is None else {"timeout": timeout}
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kw)


def global_mesh(n_dp: int = 1, backend: str | None = None,
                device="cuda") -> Mesh:
    """The (dp, rows) mesh over every rank of the job, rows = world / dp.
    Ranks are numbered host by host under ``torchrun``, so a rows group
    stays on one host's cards before it spans the next (the layout
    BASELINE.json config 4 asks for)."""
    return make_mesh(n_dp=n_dp, backend=backend, device=device)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank: int, fn, world_size: int, args: tuple, store_dir: str,
               timeout_s: float, threads: int) -> None:
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    # every rank of a local world is on this host: gloo's pairs connect
    # over the loopback interface, whatever the host name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    initialize("gloo", f"file://{store_dir}/store", world_size, rank,
               datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(Path(store_dir) / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn_local(fn, world_size: int, args: tuple = (), threads: int = 1,
                timeout_s: float = 600.0,
                store_dir: str | None = None) -> list:
    """Run ``fn(*args)`` on each rank of a new world of ``world_size``
    processes on this host (started by ``spawn``: a fork after CUDA is
    initialized breaks), joined over gloo (the ranks share this host's
    card or its CPU, and NCCL refuses two ranks on one device) through a
    FileStore in ``store_dir`` (a new temporary directory by default),
    ``threads`` torch threads a rank.
    Returns the ranks' results in rank order; a rank that raises makes
    this raise, after the other ranks are stopped.  ``fn`` and its
    results must pickle.  A collective waits at most ``timeout_s``."""
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, args, tmp, timeout_s, threads))
        results = []
        for rank in range(world_size):
            with open(Path(tmp) / f"result{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results
