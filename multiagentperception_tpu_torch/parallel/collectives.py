"""The one place where tensors move between ranks.

A ``Group`` is a set of ranks that exchange tensors: the ``torch.distributed``
process group, its global ranks in order, this process's index among them,
the backend and the device its tensors live on. A group of one made without
a process group (a data or agent group of size 1 inside a larger world)
moves nothing: every function returns its input. The world group of a
world of one keeps its process group, so a trainer launched as one rank
still issues its collectives (under NCCL, inside its CUDA graph).

- ``nccl``: every function is the direct collective; ``ring_shift`` is
  ``batch_isend_irecv``.
- ``gloo`` on CPU tensors: the direct collectives too.
- ``gloo`` on CUDA tensors: gloo reduces and broadcasts CUDA tensors, and
  nothing else, so ``all_reduce_sum``, ``all_reduce_max`` and ``broadcast``
  are direct (gloo itself copies them to the host and back), while
  ``all_gather_cat`` and ``ring_shift`` copy through pinned host buffers,
  here and nowhere else; the compute stays on the card. ``Group.staged_bytes`` counts the bytes
  every call moves through the host, out and back.

None of these functions records gradients; ``parallel.ring`` and
``parallel.sync_bn`` write the backward passes that need them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(eq=False)
class Group:
    """Ranks that exchange tensors (module docstring). ``pg`` is None for a
    group of one that moves nothing, or ``dist.group.WORLD``'s handle."""

    ranks: tuple[int, ...]
    rank: int  # this process's index in ``ranks``
    backend: str
    device: torch.device
    pg: object = None
    staged_bytes: int = 0  # bytes moved through the host under gloo, both ways

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def moves(self) -> bool:
        """Whether a collective on this group exchanges anything (a group
        of one with a process group still issues its collectives)."""
        return self.pg is not None

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        self.staged_bytes += host.nbytes
        return host

    def _back(self, host: torch.Tensor, device: torch.device) -> torch.Tensor:
        self.staged_bytes += host.nbytes
        return host.to(device)


def _all_reduce(t: torch.Tensor, group: Group, op) -> torch.Tensor:
    if not group.moves:
        return t
    out = t.detach().clone()
    if group._staged(out):
        group.staged_bytes += 2 * out.nbytes
    dist.all_reduce(out, op=op, group=group.pg)
    return out


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, in a new tensor."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the group's ranks, in a new
    tensor."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def broadcast(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s (an index into the group), in place."""
    if group.moves:
        if group._staged(t):
            group.staged_bytes += 2 * t.nbytes
        dist.broadcast(t, src=group.ranks[src], group=group.pg)
    return t


def all_gather_cat(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in the
    group's rank order."""
    if not group.moves:
        return t
    src = t.detach().contiguous()
    staged = group._staged(src)
    if staged:
        src = group._pinned(src)
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    out = torch.cat(parts, dim=dim)
    return group._back(out, t.device) if staged else out


def ring_shift(t: torch.Tensor, group: Group, step: int = 1) -> torch.Tensor:
    """Send ``t`` to the rank ``step`` places on and return the tensor
    received from the rank ``step`` places back (equal shapes)."""
    if not group.moves or group.size == 1:
        return t
    send = t.detach().contiguous()
    staged = group._staged(send)
    if staged:
        send = group._pinned(send)
    recv = torch.empty_like(send)
    to = group.ranks[(group.rank + step) % group.size]
    frm = group.ranks[(group.rank - step) % group.size]
    ops = [dist.P2POp(dist.isend, send, to, group.pg), dist.P2POp(dist.irecv, recv, frm, group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return group._back(recv, t.device) if staged else recv


def barrier(group: Group) -> None:
    """Return once every rank of the group got here (a one-element
    all-reduce on the group's device: NCCL's ``barrier`` guesses a device)."""
    if group.moves:
        all_reduce_sum(torch.ones(1, device=group.device), group)


def gather_ints(values: list[int], group: Group) -> list[list[int]]:
    """Every rank's list of ints (equal lengths), in rank order."""
    t = torch.tensor(values, dtype=torch.int64, device=group.device)
    return all_gather_cat(t[None], group, dim=0).cpu().tolist()
