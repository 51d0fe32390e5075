"""Every collective of the sharded prover and verifier, in one place.

The (dp, rows) decomposition (``parallel/sharded.py``) needs three: the
all-gather that assembles the Ajtai commitment t from each rank's kappa
rows, the all-reduce (sum) of the u1 and u2 partials, and the all-gather
of the dp blocks' transcripts.  They run over a process group of the
mesh's backend, which the caller chose (``parallel/mesh.py``):

* NCCL, each rank on its own card: the tensors stay on the card.
* gloo, ranks that share one card or run on the CPU: gloo reduces and
  gathers host memory (its all-gather of CUDA tensors is refused by some
  builds), so a CUDA tensor is staged: copied to the host, reduced or
  gathered there and copied back.  The kernels still run on the card;
  only the collective's operands travel through host memory.

Each call is recorded in the caller's ``CollectiveStats``: its count, the
bytes it staged through the host, the seconds of those copies, and its
seconds in all (host clock, after a device sync when the operand is on a
card; the collective itself waits for the group's slowest rank), so that
a run can print what the collectives cost.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass
class CollectiveStats:
    """Per collective: calls, bytes staged through the host, seconds of
    the staging copies, seconds in all."""

    calls: dict[str, int] = field(default_factory=dict)
    staged_bytes: dict[str, int] = field(default_factory=dict)
    stage_seconds: dict[str, float] = field(default_factory=dict)
    seconds: dict[str, float] = field(default_factory=dict)

    def record(self, name: str, staged: int, stage_s: float,
               seconds: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.staged_bytes[name] = self.staged_bytes.get(name, 0) + staged
        self.stage_seconds[name] = self.stage_seconds.get(name, 0.0) \
            + stage_s
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def as_dict(self) -> dict:
        return {name: {"calls": n, "staged_bytes": self.staged_bytes[name],
                       "stage_ms": self.stage_seconds[name] * 1e3,
                       "ms": self.seconds[name] * 1e3}
                for name, n in self.calls.items()}


def _staged(x: torch.Tensor, group) -> bool:
    """Whether the collective takes x through host memory: a gloo group
    and a tensor that is not on the CPU."""
    return dist.get_backend(group) == "gloo" and x.device.type != "cpu"


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def all_reduce_sum(x: torch.Tensor, group,
                   stats: CollectiveStats | None = None,
                   name: str = "all_reduce") -> torch.Tensor:
    """The sum of x over the group's ranks (int64 sums of residues are
    exact: n_shards * q is far below 2^63), on x's device; x is left as
    it was.  A group of one rank returns x itself."""
    if dist.get_world_size(group) == 1:
        return x
    t0 = time.perf_counter()
    staged = _staged(x, group)
    buf = x.cpu() if staged else x.clone()
    t1 = time.perf_counter()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    t2 = time.perf_counter()
    out = buf.to(x.device) if staged else buf
    if stats is not None:
        _sync(out)
        t3 = time.perf_counter()
        stats.record(name, 2 * buf.numel() * buf.element_size()
                     if staged else 0,
                     (t1 - t0) + (t3 - t2) if staged else 0.0, t3 - t0)
    return out


def all_gather_cat(x: torch.Tensor, dim: int, group,
                   stats: CollectiveStats | None = None,
                   name: str = "all_gather") -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in the group's rank order,
    on x's device.  Every rank's x has the same shape.  A bool tensor
    travels as uint8.  A group of one rank returns x itself."""
    if dist.get_world_size(group) == 1:
        return x
    t0 = time.perf_counter()
    staged = _staged(x, group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = (src.cpu() if staged else src).contiguous()
    t1 = time.perf_counter()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    t2 = time.perf_counter()
    if staged:
        out = out.to(x.device)
    if x.dtype == torch.bool:
        out = out.bool()
    if stats is not None:
        _sync(out)
        t3 = time.perf_counter()
        nbytes = (src.numel() + out.numel()) * src.element_size()
        stats.record(name, nbytes if staged else 0,
                     (t1 - t0) + (t3 - t2) if staged else 0.0, t3 - t0)
    return out
