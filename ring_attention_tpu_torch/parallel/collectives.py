"""The ring's transport: which ranks this process holds, and how a payload
moves one rank along.

The JAX ring rotates with ``lax.ppermute`` over a mesh axis
(``ring_attention_tpu/parallel/ring.py::_rotate``).  Here the rotation sits
behind a small :class:`Ring` interface with two implementations:

- :class:`VirtualRing`: every rank of the ring lives in this process (one
  GPU, or a CPU test).  A rotation is a rotation of a Python list: no
  device copy, no communication.
- :class:`DistributedRing`: one rank per process, over
  ``torch.distributed.batch_isend_irecv`` (gloo on the CPU, NCCL across
  GPUs), within a process group.

Beside the rotation the seam has one collective, ``all_gather``: each held
rank's view of the rank-major concatenation of every rank's payload (the
JAX ``lax.all_gather(..., tiled=True)`` of the fused ring's local tier,
``ring_attention_tpu/parallel/ring.py::_gather_seq``), and one property,
``colocated``: whether one kernel launch can address every rank, so that
the fused ring's remote tier can pass KV between the ranks inside it (the
port's counterpart of ``pallas_ring.neighbor_mesh_coords`` not returning
None).

A ring function handles a *list of payloads*, one per rank this process
holds (``ring.ranks``, in order); each payload is a tuple of tensors that
travel together.  ``quantize_ring_payload`` and the other payload codecs of
the JAX module arrive with the ring variants (ROADMAP.md Port queue
item 7).
"""

from __future__ import annotations

import abc

import torch

Payload = tuple[torch.Tensor, ...]


def ring_perm(world: int, shift: int = 1) -> list[tuple[int, int]]:
    """``(source, destination)`` rank pairs of a rotation by ``shift``."""
    return [(j, (j + shift) % world) for j in range(world)]


class Ring(abc.ABC):
    """A ring of ``world`` ranks, of which this process holds ``ranks``."""

    world: int
    ranks: tuple[int, ...]
    # Every rank lives in this process, on one device: one launch can hold
    # them all.  Static, from the ring's kind, never probed.
    colocated: bool = False

    @abc.abstractmethod
    def rotate(self, payloads: list[Payload], shift: int) -> list[Payload]:
        """Send each held rank's payload to rank ``(rank + shift) % world``
        and return, for each held rank in order, the payload that rank
        received (the one of rank ``(rank - shift) % world``)."""

    @abc.abstractmethod
    def all_gather(self, payloads: list[Payload], dim: int) -> list[Payload]:
        """Concatenate every rank's payload, tensor by tensor, along
        ``dim`` in rank order, and return that concatenation for each held
        rank in order (the fused ring's one collective)."""


class VirtualRing(Ring):
    """All ``world`` ranks in this process; a rotation moves no data."""

    colocated = True

    def __init__(self, world: int):
        if world < 1:
            raise ValueError(f"VirtualRing: world must be >= 1, got {world}")
        self.world = world
        self.ranks = tuple(range(world))

    def rotate(self, payloads: list[Payload], shift: int) -> list[Payload]:
        if len(payloads) != self.world:
            raise ValueError(
                f"VirtualRing.rotate: {len(payloads)} payloads for a ring of "
                f"{self.world}"
            )
        out: list = [None] * self.world
        for src, dst in ring_perm(self.world, shift):
            out[dst] = payloads[src]
        return out

    def all_gather(self, payloads: list[Payload], dim: int) -> list[Payload]:
        """One ``torch.cat`` per tensor, shared by every rank: no bytes move
        between devices, as none do in :meth:`rotate`."""
        if len(payloads) != self.world:
            raise ValueError(
                f"VirtualRing.all_gather: {len(payloads)} payloads for a ring "
                f"of {self.world}"
            )
        gathered = tuple(torch.cat(parts, dim=dim) for parts in zip(*payloads))
        return [gathered] * self.world

    def __repr__(self) -> str:
        return f"VirtualRing(world={self.world})"


class DistributedRing(Ring):
    """One rank per process: the ranks of ``group`` (the default group when
    None) in group-rank order.  ``torch.distributed`` must be initialized."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "DistributedRing: torch.distributed is not initialized; call "
                "init_process_group first"
            )
        self.group = group if group is not None else dist.group.WORLD
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ranks = (self.rank,)

    def rotate(self, payloads: list[Payload], shift: int) -> list[Payload]:
        import torch.distributed as dist

        if len(payloads) != 1:
            raise ValueError(
                f"DistributedRing.rotate: one payload per process, got "
                f"{len(payloads)}"
            )
        if shift % self.world == 0:
            return payloads
        (payload,) = payloads
        dst = dist.get_global_rank(self.group, (self.rank + shift) % self.world)
        src = dist.get_global_rank(self.group, (self.rank - shift) % self.world)
        sent = tuple(x.contiguous() for x in payload)
        received = tuple(torch.empty_like(x) for x in sent)
        ops = [dist.P2POp(dist.isend, x, dst, self.group) for x in sent]
        ops += [dist.P2POp(dist.irecv, y, src, self.group) for y in received]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return [received]

    def all_gather(self, payloads: list[Payload], dim: int) -> list[Payload]:
        """``torch.distributed.all_gather`` within the group, tensor by
        tensor (a bool tensor travels as uint8)."""
        import torch.distributed as dist

        if len(payloads) != 1:
            raise ValueError(
                f"DistributedRing.all_gather: one payload per process, got "
                f"{len(payloads)}"
            )
        gathered = []
        for x in payloads[0]:
            sent = x.contiguous()
            if sent.dtype == torch.bool:
                sent = sent.to(torch.uint8)
            parts = [torch.empty_like(sent) for _ in range(self.world)]
            dist.all_gather(parts, sent, group=self.group)
            gathered.append(torch.cat(parts, dim=dim).to(x.dtype))
        return [tuple(gathered)]

    def __repr__(self) -> str:
        return f"DistributedRing(world={self.world}, rank={self.rank})"
