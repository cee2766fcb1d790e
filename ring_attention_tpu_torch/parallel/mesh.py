"""The ``(data, seq)`` mesh: how many batch replicas and ring ranks, and the
ring this process takes part in.

Port of the ``(data, seq)`` part of ``ring_attention_tpu/parallel/mesh.py``
(``create_mesh`` :85, ``seq_world``/``data_world`` :272-300,
``validate_seq_len`` :420).  A JAX mesh places devices; here the mesh names
its :class:`~.collectives.Ring`:

- without ``torch.distributed`` (one process, one GPU or the CPU) the ring
  is a :class:`~.collectives.VirtualRing` holding every rank, and the data
  degree is 1;
- with ``torch.distributed`` initialized, the world's processes form a
  row-major ``(data, seq)`` grid, as the JAX mesh reshapes its devices, and
  each row is a :class:`~.collectives.DistributedRing` over its own process
  group.

The torus ring order, the factored ``(data, ring, ulysses)`` mesh and the
``dcn_data`` level are not ported (ROADMAP.md Port queue item 7).
"""

from __future__ import annotations

from dataclasses import dataclass

from .collectives import DistributedRing, Ring, VirtualRing

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class Mesh:
    """``data`` batch replicas times ``seq`` ring ranks; ``ring`` is the
    ring of this process's row, ``data_rank`` the row's index."""

    data: int
    seq: int
    ring: Ring
    data_rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}


def create_mesh(ring_size: int | None = None, data_size: int | None = None) -> Mesh:
    """Build a ``(data, seq)`` mesh.

    Over ``torch.distributed``, ``ring_size`` defaults to every process (one
    big ring) and ``data_size`` to ``world // ring_size``, the JAX
    defaults.  In one process the mesh holds a virtual ring of ``ring_size``
    ranks (default 1) and one data replica."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        ring_size = 1 if ring_size is None else ring_size
        if data_size not in (None, 1):
            raise ValueError(
                f"create_mesh: data_size {data_size} needs torch.distributed "
                f"(one process holds one data replica)"
            )
        return Mesh(data=1, seq=ring_size, ring=VirtualRing(ring_size))
    n = dist.get_world_size()
    if ring_size is None:
        ring_size = n if data_size is None else n // data_size
    if data_size is None:
        data_size = n // ring_size
    if data_size * ring_size != n:
        raise ValueError(f"create_mesh: mesh {data_size}x{ring_size} != {n} processes")
    rank = dist.get_rank()
    mine = None
    for row in range(data_size):  # every process creates every group, in order
        group = dist.new_group(list(range(row * ring_size, (row + 1) * ring_size)))
        if row == rank // ring_size:
            mine = group
    return Mesh(data=data_size, seq=ring_size, ring=DistributedRing(mine),
                data_rank=rank // ring_size)


def data_world(mesh: Mesh | None) -> int:
    """Data-parallel degree."""
    return 1 if mesh is None else mesh.data


def seq_world(mesh: Mesh | None) -> int:
    """Number of sequence shards (the ring size)."""
    return 1 if mesh is None else mesh.seq


def validate_seq_len(seq_len: int, mesh: Mesh | None) -> None:
    """One-line divisibility diagnostic: an exact sequence split over the
    ring, as a resumed run needs."""
    if mesh is None:
        return
    world = seq_world(mesh)
    if seq_len % world != 0:
        raise ValueError(
            f"seq_len {seq_len} % sequence world {world} (seq={world}) != 0 — "
            f"resume at this device count needs seq_len divisible by "
            f"{world}; pad the sequence or pick a ring size that divides "
            f"{seq_len}"
        )
