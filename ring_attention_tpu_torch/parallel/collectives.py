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
  GPUs), within a process group; its all-to-all is point to point too.
  On a gloo group the ring stages CUDA
  payloads through host memory (gloo moves no CUDA tensor point to point
  and NCCL takes no two ranks on one card): that is the transport of
  several processes sharing one GPU, never a fallback of the compute,
  which stays on the card.

Beside the rotation the seam has three collectives and one property:

- ``all_gather``: each held rank's view of the rank-major concatenation of
  every rank's payload (the JAX ``lax.all_gather(..., tiled=True)`` of the
  fused ring's local tier, ``ring_attention_tpu/parallel/ring.py::
  _gather_seq``, and of zig-zag, ``parallel/zigzag.py``).  It carries
  gradients, as ``lax.all_gather`` transposes to a reduce-scatter: on a
  ``VirtualRing`` through ``torch.cat``, on a ``DistributedRing`` through
  an autograd function whose backward sums the gathered gradient over the
  ranks (gloo has no reduce-scatter: an all-reduce, then each rank keeps
  its own slice);
- ``all_reduce(op)``: the elementwise ``"max"`` or ``"sum"`` of every
  rank's payload (``lax.pmax`` / ``lax.psum`` of tree decoding,
  ``parallel/tree_decode.py``), for each held rank;
- ``all_to_all(split_dim, concat_dim)``: the tiled ``lax.all_to_all`` of
  Ulysses and the hybrid strategy (``parallel/ulysses.py``,
  ``parallel/hybrid.py``): rank ``j`` receives chunk ``j`` of every rank's
  payload along ``split_dim``, concatenated along ``concat_dim`` in rank
  order.  It carries gradients: its backward is the inverse all-to-all (on
  a ``VirtualRing`` through ``split`` and ``cat``, on a
  ``DistributedRing`` through an autograd function);
- ``colocated``: whether one kernel launch can address every rank, so
  that the fused ring's remote tier can pass KV between the ranks inside
  it (the port's counterpart of ``pallas_ring.neighbor_mesh_coords`` not
  returning None).

A ring function handles a *list of payloads*, one per rank this process
holds (``ring.ranks``, in order); each payload is a tuple of tensors that
travel together.  A ``VirtualRing`` counts in ``calls`` the tensors each
of the four operations has moved (one per tensor a call carries): how many
times a strategy moves K/V is read there (a ``DistributedRing`` counts the
payloads it stages through the host, ``staged_calls``).
The ragged-batch helpers (``gather_sizes``, ``all_gather_variable``,
``compact_masked``, ``split_by_rank``, ``fold_batch_into_seq``,
``unfold_seq_into_batch``; JAX ``parallel/collectives.py:48-188``) sit on
the same seam, and ``VirtualRing.rotations`` counts its rotations (one per
call, the JAX ring's collective-permutes where a payload is one array).
``quantize_ring_payload`` and ``dequantize_ring_payload``
are the ring's int8 wire codec (``hop_compression="int8"``, JAX
``parallel/collectives.py:123, :158``): the K/V of a rank quantized once
at ring entry into one int8 payload, which then moves unchanged.
"""

from __future__ import annotations

import abc

import torch

from ..ops import quant

Payload = tuple[torch.Tensor, ...]


def ring_perm(world: int, shift: int = 1) -> list[tuple[int, int]]:
    """``(source, destination)`` rank pairs of a rotation by ``shift``."""
    return [(j, (j + shift) % world) for j in range(world)]


def quantize_ring_payload(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Int8-compress one rank's hop payload (``hop_compression="int8"``):
    ONE ``(2, b, hk, n, d + 4)`` int8 tensor, k at index 0 and v at 1, each
    row's values in ``[0:d]`` and its f32 absmax scale as four bytes in
    ``[d:d + 4]`` (``quant.pack_kv``, per-row scales).  The ring quantizes
    once at entry and circulates the bytes unchanged: every hop is a
    lossless move, so the error is one quantization whatever the ring's
    size, and a hop moves ``d + 4`` bytes a row for ``2d`` in bf16."""
    return quant.pack_kv(k, v)


def dequantize_ring_payload(payload: torch.Tensor,
                            dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(k, v)`` a compressed hop payload represents, in ``dtype``."""
    return quant.unpack_kv(payload, dtype)


class Ring(abc.ABC):
    """A ring of ``world`` ranks, of which this process holds ``ranks``."""

    world: int
    ranks: tuple[int, ...]
    # Every rank lives in this process, on one device: one launch can hold
    # them all.  Static, from the ring's kind, never probed.
    colocated: bool = False

    @property
    def spans_processes(self) -> bool:
        """Whether the ring's ranks live in more than this process (a
        ``DistributedRing`` of more than one process): each process then
        holds its ranks' blocks of a sequence, not the whole of it."""
        return len(self.ranks) < self.world

    @abc.abstractmethod
    def rotate(self, payloads: list[Payload], shift: int) -> list[Payload]:
        """Send each held rank's payload to rank ``(rank + shift) % world``
        and return, for each held rank in order, the payload that rank
        received (the one of rank ``(rank - shift) % world``)."""

    @abc.abstractmethod
    def all_gather(self, payloads: list[Payload], dim: int) -> list[Payload]:
        """Concatenate every rank's payload, tensor by tensor, along
        ``dim`` in rank order, and return that concatenation for each held
        rank in order, differentiably (the fused ring's and zig-zag's
        gather)."""

    @abc.abstractmethod
    def all_reduce(self, payloads: list[Payload], op: str) -> list[Payload]:
        """Reduce every rank's payload, tensor by tensor and elementwise,
        with ``op`` (``"max"`` or ``"sum"``), and return the result for each
        held rank in order (tree decoding's merge and the gather's
        backward)."""

    @abc.abstractmethod
    def all_to_all(self, payloads: list[Payload], split_dim: int,
                   concat_dim: int) -> list[Payload]:
        """Tensor by tensor: cut every rank's payload into ``world`` equal
        chunks along ``split_dim`` and give rank ``j`` chunk ``j`` of every
        rank's, concatenated along ``concat_dim`` in rank order (JAX
        ``lax.all_to_all(..., tiled=True)``), for each held rank in order,
        differentiably."""


OPS = ("rotate", "all_gather", "all_reduce", "all_to_all")
REDUCE_OPS = ("max", "sum")


def _check_op(fn: str, op: str) -> None:
    if op not in REDUCE_OPS:
        raise ValueError(f"{fn}: op must be one of {REDUCE_OPS}, got {op!r}")


def _check_split(fn: str, payloads: list[Payload], split_dim: int, world: int) -> None:
    for payload in payloads:
        for x in payload:
            if x.shape[split_dim] % world:
                raise ValueError(
                    f"{fn}: dimension {split_dim} of size {x.shape[split_dim]} does not "
                    f"split over {world} ranks"
                )


class VirtualRing(Ring):
    """All ``world`` ranks in this process; a rotation moves no data."""

    colocated = True

    def __init__(self, world: int):
        if world < 1:
            raise ValueError(f"VirtualRing: world must be >= 1, got {world}")
        self.world = world
        self.ranks = tuple(range(world))
        self.calls = dict.fromkeys(OPS, 0)
        self.rotations = 0

    def _check(self, fn: str, payloads: list[Payload]) -> None:
        if len(payloads) != self.world:
            raise ValueError(
                f"VirtualRing.{fn}: {len(payloads)} payloads for a ring of {self.world}"
            )
        self.calls[fn] += len(payloads[0])

    def rotate(self, payloads: list[Payload], shift: int) -> list[Payload]:
        self._check("rotate", payloads)
        self.rotations += 1
        out: list = [None] * self.world
        for src, dst in ring_perm(self.world, shift):
            out[dst] = payloads[src]
        return out

    def all_gather(self, payloads: list[Payload], dim: int) -> list[Payload]:
        """One ``torch.cat`` per tensor, shared by every rank: no bytes move
        between devices, as none do in :meth:`rotate`."""
        self._check("all_gather", payloads)
        gathered = tuple(torch.cat(parts, dim=dim) for parts in zip(*payloads))
        return [gathered] * self.world

    def all_reduce(self, payloads: list[Payload], op: str) -> list[Payload]:
        """The ranks' tensors folded in rank order, one result shared by
        every rank."""
        _check_op("VirtualRing.all_reduce", op)
        self._check("all_reduce", payloads)
        fold = torch.maximum if op == "max" else torch.add
        reduced = []
        for parts in zip(*payloads):
            acc = parts[0]
            for x in parts[1:]:
                acc = fold(acc, x)
            reduced.append(acc)
        return [tuple(reduced)] * self.world

    def all_to_all(self, payloads: list[Payload], split_dim: int,
                   concat_dim: int) -> list[Payload]:
        """A reshuffle of the held payloads: one ``torch.cat`` per rank and
        tensor of the chunks ``split`` cuts (views), differentiable through
        autograd."""
        self._check("all_to_all", payloads)
        _check_split("VirtualRing.all_to_all", payloads, split_dim, self.world)
        chunks = [tuple(x.chunk(self.world, dim=split_dim) for x in payload)
                  for payload in payloads]
        return [tuple(torch.cat([chunks[i][t][j] for i in range(self.world)], dim=concat_dim)
                      for t in range(len(payloads[0])))
                for j in range(self.world)]

    def __repr__(self) -> str:
        return f"VirtualRing(world={self.world})"


class DistributedRing(Ring):
    """One rank per process: the ranks of ``group`` (the default group when
    None) in group-rank order.  ``torch.distributed`` must be initialized.

    The transport follows the group's backend, read once here: on NCCL a
    payload stays on its device; on gloo, which has no CUDA point-to-point
    and no CUDA all-gather, a CUDA payload is copied to host memory, moved
    by gloo, and copied back to the payload's device (``host_staged``).
    That is how several processes share one card (NCCL refuses two ranks
    on one device); the kernels run on the card either way.
    ``staged_bytes`` counts the bytes each collective copied between
    device and host (both ways) and ``staged_calls`` its staged calls (one
    per tensor for ``all_gather`` and ``all_to_all``, one per payload for
    ``rotate`` and ``all_reduce``).  The all-to-all runs point to point on
    every backend, as the rotation does (gloo's CUDA builds have no
    all-to-all; NCCL's is grouped sends and receives itself)."""

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
        self.host_staged = dist.get_backend(self.group) == "gloo"
        self.staged_bytes = dict.fromkeys(OPS, 0)
        self.staged_calls = dict.fromkeys(OPS, 0)

    def _to_wire(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` as the backend moves it: contiguous, and in host memory when
        the ring stages a CUDA tensor."""
        x = x.contiguous()
        if self.host_staged and x.is_cuda:
            self.staged_bytes[op] += x.numel() * x.element_size()
            x = x.cpu()
        return x

    def _from_wire(self, y: torch.Tensor, device: torch.device, op: str) -> torch.Tensor:
        """A received tensor back on the payload's device."""
        if y.device != device:
            self.staged_bytes[op] += y.numel() * y.element_size()
            y = y.to(device)
        return y

    def _staged(self, payload, op: str) -> None:
        if self.host_staged and any(x.is_cuda for x in payload):
            self.staged_calls[op] += 1

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
        self._staged(payload, "rotate")
        sent = tuple(self._to_wire(x, "rotate") for x in payload)
        received = tuple(torch.empty_like(x) for x in sent)
        ops = [dist.P2POp(dist.isend, x, dst, self.group) for x in sent]
        ops += [dist.P2POp(dist.irecv, y, src, self.group) for y in received]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return [tuple(self._from_wire(y, x.device, "rotate")
                      for y, x in zip(received, payload))]

    def all_gather(self, payloads: list[Payload], dim: int) -> list[Payload]:
        """``torch.distributed.all_gather`` within the group, tensor by
        tensor (a bool tensor travels as uint8); a tensor that requires
        grad gathers through :class:`_GatherWithGrad`."""
        if len(payloads) != 1:
            raise ValueError(
                f"DistributedRing.all_gather: one payload per process, got "
                f"{len(payloads)}"
            )
        gathered = []
        for x in payloads[0]:
            if x.requires_grad:
                gathered.append(_GatherWithGrad.apply(x, dim, self))
            else:
                gathered.append(self._gather(x, dim))
        return [tuple(gathered)]

    def _gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        self._staged((x,), "all_gather")
        sent = self._to_wire(x, "all_gather")
        if sent.dtype == torch.bool:
            sent = sent.to(torch.uint8)
        parts = [torch.empty_like(sent) for _ in range(self.world)]
        dist.all_gather(parts, sent, group=self.group)
        return self._from_wire(torch.cat(parts, dim=dim), x.device,
                               "all_gather").to(x.dtype)

    def all_reduce(self, payloads: list[Payload], op: str) -> list[Payload]:
        """``torch.distributed.all_reduce`` within the group, tensor by
        tensor, on copies (the payload is left as it was)."""
        import torch.distributed as dist

        _check_op("DistributedRing.all_reduce", op)
        if len(payloads) != 1:
            raise ValueError(
                f"DistributedRing.all_reduce: one payload per process, got "
                f"{len(payloads)}"
            )
        reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._staged(payloads[0], "all_reduce")
        reduced = []
        for x in payloads[0]:
            y = self._to_wire(x.detach().clone(memory_format=torch.contiguous_format),
                              "all_reduce")
            dist.all_reduce(y, op=reduce_op, group=self.group)
            reduced.append(self._from_wire(y, x.device, "all_reduce"))
        return [tuple(reduced)]

    def all_to_all(self, payloads: list[Payload], split_dim: int,
                   concat_dim: int) -> list[Payload]:
        """The tiled all-to-all within the group, tensor by tensor, through
        :class:`_AllToAll` (its backward is the inverse exchange)."""
        if len(payloads) != 1:
            raise ValueError(
                f"DistributedRing.all_to_all: one payload per process, got "
                f"{len(payloads)}"
            )
        _check_split("DistributedRing.all_to_all", payloads, split_dim, self.world)
        return [tuple(_AllToAll.apply(x, split_dim, concat_dim, self)
                      for x in payloads[0])]

    def _exchange(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """One tiled all-to-all of ``x``; a bool tensor travels as uint8.
        Each chunk goes point to point to its rank (``batch_isend_irecv``,
        as a rotation moves its payload): the same bytes as the
        collective."""
        import torch.distributed as dist

        self._staged((x,), "all_to_all")
        sent = self._to_wire(x, "all_to_all")
        if sent.dtype == torch.bool:
            sent = sent.to(torch.uint8)
        parts = [c.contiguous() for c in sent.chunk(self.world, dim=split_dim)]
        received = [torch.empty_like(c) for c in parts]
        received[self.rank] = parts[self.rank]
        ops = []
        for j in range(self.world):
            if j != self.rank:
                peer = dist.get_global_rank(self.group, j)
                ops += [dist.P2POp(dist.isend, parts[j], peer, self.group),
                        dist.P2POp(dist.irecv, received[j], peer, self.group)]
        for request in dist.batch_isend_irecv(ops) if ops else ():
            request.wait()
        return self._from_wire(torch.cat(received, dim=concat_dim), x.device,
                               "all_to_all").to(x.dtype)

    def __repr__(self) -> str:
        return f"DistributedRing(world={self.world}, rank={self.rank})"


class _GatherWithGrad(torch.autograd.Function):
    """``DistributedRing`` all-gather whose backward is the reduce-scatter
    (the transpose of ``lax.all_gather``): the gathered gradient summed over
    the ranks, of which each keeps its own slice along ``dim``."""

    @staticmethod
    def forward(ctx, x, dim, ring):
        ctx.dim, ctx.ring, ctx.size = dim, ring, x.shape[dim]
        return ring._gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        (total,) = ctx.ring.all_reduce([(grad,)], "sum")[0]
        mine = total.narrow(ctx.dim, ctx.ring.rank * ctx.size, ctx.size)
        return mine.contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """``DistributedRing`` tiled all-to-all whose backward is the inverse
    exchange (the transpose of ``lax.all_to_all``): the gradient cut along
    ``concat_dim`` and concatenated along ``split_dim``."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, ring):
        ctx.split_dim, ctx.concat_dim, ctx.ring = split_dim, concat_dim, ring
        return ring._exchange(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ring._exchange(grad, ctx.concat_dim, ctx.split_dim), None, None, None


# ---------------------------------------------------------------------------
# Ragged batches (JAX parallel/collectives.py:48-188, the reference's
# distributed.py:50-127): sizes, a variable-size gather, rank splitting and
# batch folding, each held rank's shard a list entry as every ring
# function takes it
# ---------------------------------------------------------------------------


def gather_sizes(sizes: list, ring: Ring) -> torch.Tensor:
    """Every rank's size, ``(world,)`` int64 in rank order (JAX
    ``gather_sizes``): ``sizes`` holds one int or 0-d tensor per held rank.
    One all-gather of one int per rank, on the sizes' device (the CPU for
    ints)."""
    local = [(torch.as_tensor(s, dtype=torch.int64).reshape(1),) for s in sizes]
    if ring.world == 1:
        return local[0][0]
    return ring.all_gather(local, 0)[0][0]


def all_gather_variable(xs: list, lengths: list, ring: Ring, *,
                        max_size: int | None = None,
                        axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather shards whose USED length differs per rank (JAX
    ``all_gather_variable``).  Each held rank's ``x`` is padded to a common
    ``max_size`` along ``axis`` (default its size there) and ``lengths``
    holds its used length.  Returns ``(gathered, mask)``: the ``world *
    max_size`` entries along ``axis`` in rank order, and the flat bool
    validity mask ``(world * max_size,)``; :func:`compact_masked` drops the
    padding.  The gather carries gradients, as ``Ring.all_gather`` does."""
    if max_size is None:
        max_size = xs[0].shape[axis]
    for x in xs:
        if x.shape[axis] != max_size:
            raise ValueError(
                f"all_gather_variable: pad x to max_size {max_size} along axis {axis} "
                f"before gathering, got {x.shape[axis]}"
            )
    gathered = xs[0] if ring.world == 1 else ring.all_gather([(x,) for x in xs], axis)[0][0]
    sizes = gather_sizes(lengths, ring).to(gathered.device)
    slot = torch.arange(ring.world * max_size, device=gathered.device)
    return gathered, slot % max_size < sizes[slot // max_size]


def compact_masked(gathered: torch.Tensor, mask: torch.Tensor, *,
                   axis: int = 0) -> torch.Tensor:
    """Drop the padding slots of an :func:`all_gather_variable` result: the
    dense rank-order concatenation of the used entries (JAX
    ``compact_masked``).  Its length depends on the data, so the mask is
    read on the host: one sync."""
    if tuple(mask.shape) != (gathered.shape[axis],):
        raise ValueError(
            f"compact_masked: mask shape {tuple(mask.shape)} must be "
            f"({gathered.shape[axis]},) — the flat validity mask returned by "
            f"all_gather_variable for axis {axis}"
        )
    keep = mask.to(torch.bool).cpu().nonzero().flatten()
    return gathered.index_select(axis, keep.to(gathered.device))


def split_by_rank(x: torch.Tensor, ring: Ring, *, axis: int = 0) -> list:
    """Each held rank's equal slice of a tensor every rank holds whole (JAX
    ``split_by_rank``), in held-rank order."""
    if x.shape[axis] % ring.world:
        raise ValueError(
            f"split_by_rank: axis {axis} size {x.shape[axis]} must divide over "
            f"{ring.world} ranks; pad first (pad_to_multiple)"
        )
    size = x.shape[axis] // ring.world
    return [x.narrow(axis, r * size, size) for r in ring.ranks]


def fold_batch_into_seq(x: torch.Tensor, num_sharded_batches: int) -> torch.Tensor:
    """``(b, n, ...) -> (b / k, k * n, ...)``: ``k`` batch groups laid side
    by side along the sequence (JAX ``fold_batch_into_seq``, the
    reference's ``sharded_batch_to_sharded_seq``)."""
    b, n, k = x.shape[0], x.shape[1], num_sharded_batches
    if b % k:
        raise ValueError(f"fold_batch_into_seq: batch {b} does not divide into {k} groups")
    return x.reshape(b // k, k * n, *x.shape[2:])


def unfold_seq_into_batch(x: torch.Tensor, num_sharded_batches: int) -> torch.Tensor:
    """Inverse of :func:`fold_batch_into_seq`."""
    b, kn, k = x.shape[0], x.shape[1], num_sharded_batches
    if kn % k:
        raise ValueError(f"unfold_seq_into_batch: sequence {kn} does not divide into {k} groups")
    return x.reshape(b * k, kn // k, *x.shape[2:])
