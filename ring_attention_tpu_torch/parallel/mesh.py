"""The ``(data, seq)`` mesh and the factored ``(data, ring, ulysses)`` one:
how many batch replicas and sequence ranks, and the rings this process
takes part in.

Port of ``ring_attention_tpu/parallel/mesh.py`` but its dcn level and
device placement (``create_mesh`` :85, ``is_factored`` :252, ``seq_axes``
:282, ``seq_world``/``data_world`` :272-300, ``validate_seq_len`` :420).
A JAX mesh places devices; here the mesh names its
:class:`~.collectives.Ring`:

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

``create_mesh(ulysses_size=U)`` factors the sequence axis for the hybrid
strategy (``parallel/hybrid.py``): ``ring_size`` is then the OUTER ring's
degree ``R`` and the sequence world ``R * U``, sharded ring-major,
ulysses-minor (combined seq rank ``r * U + u``).  Over
``torch.distributed`` the processes form a row-major ``(data, ring,
ulysses)`` grid: process ``(d * R + r) * U + u`` holds combined seq rank
``r * U + u`` of data row ``d``; ``ulysses_ring`` is the group of its U
neighbours (the all-to-alls), ``ring`` the group of the R processes with
its data row and ulysses rank (the hops), ``data_ring`` that of the D with
its ring and ulysses ranks.  In one process ``ulysses_ring`` is a
``VirtualRing(U)`` and ``ring`` a ``VirtualRing(R)``: the hybrid strategy
folds the U outer rings into the batch dimension of one ring of R.

``shard_batch`` (JAX :517) gives a process its part of a batch whose rows
it passes: on a mesh of processes the block of its sequence ranks, which
``RingTransformer(auto_shard=False)`` takes.

The torus ring order and the ``dcn_data`` level, ``remesh_plan`` and
``mesh_descriptor`` are not ported (ROADMAP.md Port queue item 7f).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .collectives import DistributedRing, Ring, VirtualRing

DATA_AXIS = "data"
SEQ_AXIS = "seq"
ULYSSES_AXIS = "ulysses"
RING_AXIS = "ring"


@dataclass(frozen=True)
class Mesh:
    """``data`` batch replicas times ``seq`` sequence ranks; ``ring`` is the
    ring of this process's row (the outer ring of a factored mesh),
    ``data_rank`` the row's index and ``data_ring`` the ring of its column
    (the same seq rank in every row; None with one row).  A factored mesh
    (``ulysses > 1``) adds ``ulysses_ring``, the all-to-all group, and its
    ``seq`` is ``ring.world * ulysses``."""

    data: int
    seq: int
    ring: Ring
    data_rank: int = 0
    data_ring: Ring | None = None
    ulysses: int = 1
    ulysses_ring: Ring | None = None

    @property
    def factored(self) -> bool:
        """Whether the sequence axis is factored (JAX ``is_factored``)."""
        return self.ulysses_ring is not None

    @property
    def shape(self) -> dict[str, int]:
        if self.factored:
            return {DATA_AXIS: self.data, RING_AXIS: self.ring.world,
                    ULYSSES_AXIS: self.ulysses}
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq}

    @property
    def seq_ranks(self) -> tuple[int, ...]:
        """The combined sequence ranks this process holds, in order (every
        one on a mesh this process holds whole)."""
        if not self.factored:
            return self.ring.ranks
        u = self.ulysses
        return tuple(r * u + j for r in self.ring.ranks for j in self.ulysses_ring.ranks)

    @property
    def seq_splits(self) -> bool:
        """Whether this process holds only part of the sequence."""
        return len(self.seq_ranks) < self.seq

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh's ranks live in more than this process: then
        each process holds its rows and its seq rank's block of a global
        batch (``parallel/sharding.py::shard_cut``)."""
        return self.data > 1 or self.seq_splits


def create_mesh(ring_size: int | None = None, data_size: int | None = None, *,
                ulysses_size: int | None = None) -> Mesh:
    """Build a ``(data, seq)`` mesh, or with ``ulysses_size=U > 1`` the
    factored ``(data, ring, ulysses)`` one, where ``ring_size`` is the OUTER
    ring's degree.

    Over ``torch.distributed``, ``ring_size`` defaults to every process (one
    big ring; factored: ``world // U`` over the data rows) and
    ``data_size`` to what is left, the JAX defaults.  In one process the
    mesh holds virtual rings (``ring_size`` ranks, default 1; factored,
    also ``U``) and one data replica."""
    import torch.distributed as dist

    u = 1 if ulysses_size is None else ulysses_size
    if u < 1:
        raise ValueError(f"create_mesh: ulysses_size must be >= 1, got {ulysses_size}")
    if not (dist.is_available() and dist.is_initialized()):
        ring_size = 1 if ring_size is None else ring_size
        if data_size not in (None, 1):
            raise ValueError(
                f"create_mesh: data_size {data_size} needs torch.distributed "
                f"(one process holds one data replica)"
            )
        if u > 1:
            return Mesh(data=1, seq=ring_size * u, ring=VirtualRing(ring_size),
                        ulysses=u, ulysses_ring=VirtualRing(u))
        return Mesh(data=1, seq=ring_size, ring=VirtualRing(ring_size))
    n = dist.get_world_size()
    if n % u:
        raise ValueError(f"create_mesh: ulysses_size {u} must divide {n} devices")
    if ring_size is None:
        ring_size = n // u if data_size is None else n // (data_size * u)
    if data_size is None:
        data_size = n // (u * ring_size)
    if data_size * u * ring_size != n:
        shape = f"{data_size}x{u}x{ring_size}" if u > 1 else f"{data_size}x{ring_size}"
        raise ValueError(f"create_mesh: mesh {shape} != {n} processes")
    rank = dist.get_rank()
    d, j = rank // (ring_size * u), rank % u
    # every process creates every group, in the same order: the ulysses
    # groups (factored), the rings (each row's, one per ulysses rank), then,
    # with more than one row, the data rings
    ulysses_ring = None
    if u > 1:
        groups = [dist.new_group(list(range(g * u, (g + 1) * u)))
                  for g in range(data_size * ring_size)]
        ulysses_ring = DistributedRing(groups[rank // u])
    rings = {(row, col): dist.new_group([(row * ring_size + i) * u + col
                                         for i in range(ring_size)])
             for row in range(data_size) for col in range(u)}
    data_ring = None
    if data_size > 1:
        columns = [dist.new_group(list(range(cell, n, ring_size * u)))
                   for cell in range(ring_size * u)]
        data_ring = DistributedRing(columns[rank % (ring_size * u)])
    return Mesh(data=data_size, seq=ring_size * u, ring=DistributedRing(rings[d, j]),
                data_rank=d, data_ring=data_ring, ulysses=u, ulysses_ring=ulysses_ring)


def is_factored(mesh: Mesh | None) -> bool:
    """Whether the mesh factors the sequence axis (hybrid Ulysses x Ring)."""
    return mesh is not None and mesh.factored


def seq_axes(mesh: Mesh) -> tuple[str, ...]:
    """The names of the axes the sequence shards over, major first."""
    return (RING_AXIS, ULYSSES_AXIS) if mesh.factored else (SEQ_AXIS,)


def mesh_all_reduce(mesh: Mesh | None, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sum of ``tensors`` over every process of the mesh,
    detached: over the ulysses group and the seq ring where their ranks are
    processes, then over the data ring.  The tensors of one dtype travel as
    one flat buffer; every process gets the same bits.  Without a mesh that
    spans processes they are returned as they are (a ``VirtualRing``'s
    ranks share one autograd graph: their sum is already in them)."""
    if mesh is None or not mesh.spans_processes:
        return tensors
    rings = [r for r in (mesh.ulysses_ring, mesh.ring)
             if r is not None and r.spans_processes]
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
    """Number of sequence shards (the ring size; both factors of a factored
    mesh)."""
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


def shard_batch(batch, mesh: Mesh | None, *, overlap: int = 0, device=None):
    """This process's part of a batch, on ``device`` (JAX ``shard_batch``:
    ``jax.make_array_from_process_local_data``).  As in JAX, every process
    passes only ITS rows of the global batch (a data loader's local slice;
    the whole batch on a mesh of one data row, and in one process), never
    the global batch; each leaf of rank >= 2, ``(b_local, n + overlap,
    ...)``, keeps the block of its sequence that this process's seq ranks
    hold (ring-major, ulysses-minor on a factored mesh: combined rank
    ``r * U + u``, JAX ``seq_sharding``), rank-1 leaves (one value a row) stay whole, and scalars
    replicate.  ``overlap=1`` keeps one token past each block: the label of
    its last position, as ``RingTransformer(auto_shard=False)`` reads a
    block's tokens ``(b_local, n_local + 1)`` with ``return_loss`` (its
    mask stays ``(b_local, n_local)``: shard it with ``overlap=0``).

    Works on a tensor, a numpy array or a Python scalar, and on dicts,
    lists and tuples of them.  The sequence must already be padded and in
    the ring's layout (``layout_for`` / ``layout_permute``), as
    ``auto_shard=False`` takes it.  ``device`` defaults to CUDA (the
    model's default); pass ``"cpu"`` to stay on the CPU."""
    from ..models.layers import resolve_device

    dev = resolve_device(device)
    world = seq_world(mesh)
    ranks = (0,) if mesh is None else mesh.seq_ranks

    def block(n: int) -> slice:
        if n % world:
            raise ValueError(
                f"shard_batch: sequence {n} does not divide over the sequence world "
                f"{world}; pad it first (pad_to_multiple)"
            )
        n_local = n // world
        return slice(ranks[0] * n_local, (ranks[-1] + 1) * n_local + overlap)

    def place(x):
        if isinstance(x, dict):
            return {key: place(value) for key, value in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(value) for value in x)
        x = torch.as_tensor(x)
        if x.dim() >= 2:
            x = x[:, block(x.shape[1] - overlap)]
        return x.to(dev).contiguous()

    return place(batch)
