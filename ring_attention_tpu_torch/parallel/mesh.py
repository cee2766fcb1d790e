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
  row-major ``(data, seq)`` grid, as the JAX mesh reshapes its devices:
  each row is a :class:`~.collectives.DistributedRing` over its own process
  group (the seq axis, JAX ``seq_partition``), and each column one over
  the processes that hold the same seq rank of every row (the data axis,
  ``data_ring``: JAX ``data_partition``).  Both rings together reach every
  process of the mesh (:func:`mesh_all_reduce`, the sum that SPMD
  partitioning inserts for the replicated parameters' gradients in JAX).

The torus ring order, the factored ``(data, ring, ulysses)`` mesh and the
``dcn_data`` level are not ported (ROADMAP.md Port queue item 7).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .collectives import DistributedRing, Ring, VirtualRing

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class Mesh:
    """``data`` batch replicas times ``seq`` ring ranks; ``ring`` is the
    ring of this process's row, ``data_rank`` the row's index and
    ``data_ring`` the ring of its column (the same seq rank in every row;
    None with one row)."""

    data: int
    seq: int
    ring: Ring
    data_rank: int = 0
    data_ring: Ring | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh's ranks live in more than this process: then
        each process holds its rows and its seq rank's block of a global
        batch (``parallel/sharding.py::shard_cut``)."""
        return self.data > 1 or self.ring.spans_processes


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
    # every process creates every group, in the same order: the rows (seq
    # rings), then, with more than one row, the columns (data rings)
    rows = [dist.new_group(list(range(row * ring_size, (row + 1) * ring_size)))
            for row in range(data_size)]
    data_ring = None
    if data_size > 1:
        columns = [dist.new_group(list(range(col, n, ring_size)))
                   for col in range(ring_size)]
        data_ring = DistributedRing(columns[rank % ring_size])
    return Mesh(data=data_size, seq=ring_size, ring=DistributedRing(rows[rank // ring_size]),
                data_rank=rank // ring_size, data_ring=data_ring)


def mesh_all_reduce(mesh: Mesh | None, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sum of ``tensors`` over every process of the mesh,
    detached: over the seq ring when its ranks are processes, then over the
    data ring.  The tensors of one dtype travel as one flat buffer; every
    process gets the same bits.  Without a mesh that spans processes they
    are returned as they are (a ``VirtualRing``'s ranks share one autograd
    graph: their sum is already in them)."""
    if mesh is None or not mesh.spans_processes:
        return tensors
    rings = [mesh.ring] if mesh.ring.spans_processes else []
    if mesh.data_ring is not None:
        rings.append(mesh.data_ring)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(tensors)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        for ring in rings:
            (flat,) = ring.all_reduce([(flat,)], "sum")[0]
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


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
