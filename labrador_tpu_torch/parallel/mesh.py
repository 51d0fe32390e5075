"""The (dp, rows) mesh over the ranks of a ``torch.distributed`` job.

Counterpart of ``labrador_tpu/parallel/mesh.py``.  The axes (SURVEY.md
§5.8):

  * ``dp``   — independent proof instances (data parallel),
  * ``rows`` — the kappa axis of the Ajtai commitment and the contraction
               of the outer commitments u1 and u2, the reference's two
               rayon sites (``proofgen.rs:101-124``,
               ``verification.rs:372-388``), split over ranks with one
               all-gather or all-reduce each.

Rank ``dp * n_rows + row`` holds mesh coordinates (dp, row), the layout of
the JAX package's ``devices.reshape(n_dp, n_rows)``: the ranks of a rows
group are consecutive, so under ``torchrun`` they share a host before the
mesh spans the next.  Every rank creates every group, in the same order,
as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .collectives import CollectiveStats


@dataclass
class Mesh:
    """This rank's place in an (n_dp, n_rows) mesh.  ``dp`` and ``row`` are
    None on a rank beyond the mesh (the mesh may leave ranks of the job
    out, as the JAX mesh leaves devices out); its groups are then None."""

    n_dp: int
    n_rows: int
    dp: int | None
    row: int | None
    rows_group: object
    dp_group: object
    device: torch.device
    backend: str
    stats: CollectiveStats = field(default_factory=CollectiveStats)

    @property
    def member(self) -> bool:
        return self.dp is not None


def rank_device(device="cuda") -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count}`` (the rank
    itself when LOCAL_RANK is unset), made the current CUDA device; any
    other device as given (the CPU for the tests)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def make_mesh(n_dp: int = 1, n_rows: int | None = None,
              backend: str | None = None, device="cuda") -> Mesh:
    """The (n_dp, n_rows) mesh over the first n_dp * n_rows ranks of the
    initialized job (``n_rows`` defaults to world_size // n_dp).  Its
    groups use ``backend`` (the job's own by default): ``nccl`` when each
    rank has its own card, ``gloo`` when ranks share one card or run on
    the CPU.  Raises if the mesh needs more ranks than the job has."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    if n_rows is None:
        n_rows = world // n_dp
    if n_dp < 1 or n_rows < 1 or n_dp * n_rows > world:
        raise ValueError(f"mesh {n_dp}x{n_rows} needs more than {world} "
                         f"ranks")
    backend = backend or dist.get_backend()
    rows_groups = [dist.new_group([d * n_rows + j for j in range(n_rows)],
                                  backend=backend) for d in range(n_dp)]
    dp_groups = [dist.new_group([d * n_rows + j for d in range(n_dp)],
                                backend=backend) for j in range(n_rows)]
    if rank >= n_dp * n_rows:
        return Mesh(n_dp, n_rows, None, None, None, None,
                    rank_device(device), backend)
    dp, row = divmod(rank, n_rows)
    return Mesh(n_dp, n_rows, dp, row, rows_groups[dp], dp_groups[row],
                rank_device(device), backend)
