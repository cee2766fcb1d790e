"""Sequence layout transforms: padding, striping and the zig-zag layout.

Port of ``ring_attention_tpu/parallel/sharding.py:23-148``.  Striping
(Striped Attention, arXiv 2311.09431) gives ring rank ``r`` of ``W`` the
tokens ``{i * W + r}``, so every hop of a causal ring has equal work; at
token granularity, as the JAX package stripes.  The zig-zag layout
(``parallel/zigzag.py``) gives rank ``r`` the chunks ``(r, 2W-1-r)`` of
``2W``.  The layouts are pure index permutations of a global ``(batch,
seq, ...)`` tensor; sharding the result contiguously over the ring gives
each rank its tokens.

:func:`layout_for` is the one derivation of a strategy's layout: Ulysses
never stripes (head parallelism balances causal work by itself), and the
hybrid strategy stripes at the OUTER ring's degree only, ``seq_world //
ulysses_size``: the all-to-all over the ulysses group reassembles
contiguous ring chunks, so striping balances ring ranks, not devices.

On a mesh whose ranks are processes every process holds the same global
batch; :func:`shard_cut` keeps its part of a padded, permuted tensor (its
data rows and its combined seq rank's contiguous block: what
``NamedSharding(P(data, seq))`` gives a device in JAX; on a factored mesh
rank ``r * U + u`` of ``R * U``, ``P(data, ("ring", "ulysses"))``) and
:func:`shard_gather` is the inverse (the blocks gathered over the ulysses
group and then the ring, the rows over the data ring, then un-permuted);
:func:`cut_rows` and :func:`gather_rows` do the rows alone (decoding).
On a mesh that one process holds they change nothing but the un-permute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .zigzag import zigzag_permute, zigzag_unpermute

STRATEGIES = ("ring", "zigzag", "ulysses", "hybrid")


def pad_to_multiple(
    x: torch.Tensor, multiple: int, axis: int = 1, value: float = 0.0
) -> tuple[torch.Tensor, int]:
    """Pad ``axis`` up to a multiple; returns ``(padded, original_length)``."""
    n = x.shape[axis]
    rem = n % multiple
    if rem == 0:
        return x, n
    pad = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, multiple - rem]
    return F.pad(x, pad, value=value), n


def pad_seq_and_mask(
    x: torch.Tensor, mask: torch.Tensor | None, multiple: int
) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """Pad tokens and key-padding mask together; when padding is added and
    no mask exists, one is made so padded positions never receive
    attention."""
    x_padded, n = pad_to_multiple(x, multiple)
    if x_padded.shape[1] == n and mask is None:
        return x_padded, None, n
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    mask_padded, _ = pad_to_multiple(mask, multiple, axis=1, value=False)
    return x_padded, mask_padded, n


def _check_divides(fn: str, n: int, ring_size: int) -> None:
    if n % ring_size:
        raise ValueError(f"{fn}: sequence {n} does not divide over {ring_size} ranks")


def stripe_permute(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """``[x0, x1, ..., x_{n-1}] -> [x0, x_W, x_2W, ..., x1, x_{1+W}, ...]``:
    sharding the result contiguously over ``W`` ranks gives rank ``r`` the
    tokens ``≡ r (mod W)``."""
    n = x.shape[axis]
    _check_divides("stripe_permute", n, ring_size)
    shape = list(x.shape)
    x = x.reshape(shape[:axis] + [n // ring_size, ring_size] + shape[axis + 1:])
    return x.transpose(axis, axis + 1).reshape(shape)


def stripe_unpermute(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`stripe_permute`."""
    n = x.shape[axis]
    _check_divides("stripe_unpermute", n, ring_size)
    shape = list(x.shape)
    x = x.reshape(shape[:axis] + [ring_size, n // ring_size] + shape[axis + 1:])
    return x.transpose(axis, axis + 1).reshape(shape)


def layout_for(sequence_parallel: str, striped: bool, seq_world: int,
               ulysses_size: int = 1) -> tuple[str, int]:
    """``(scheme, factor)`` of the model-top sequence permutation: the one
    derivation the attention layer and the transformer both consult.  The
    factor is the degree the layout interleaves at: the whole sequence
    world for the 1-D schemes, the outer ring's for hybrid."""
    if sequence_parallel not in STRATEGIES:
        raise ValueError(f"unknown sequence_parallel {sequence_parallel!r}")
    if seq_world <= 1:
        return "contiguous", 1
    if sequence_parallel == "zigzag":
        return "zigzag", seq_world
    if not striped:
        return "contiguous", seq_world
    if sequence_parallel == "hybrid":
        return "striped", seq_world // ulysses_size
    if sequence_parallel == "ring":
        return "striped", seq_world
    return "contiguous", seq_world  # ulysses: no striping


def layout_permute(x: torch.Tensor, scheme: str, factor: int) -> torch.Tensor:
    """Apply the sequence-layout permutation one scheme needs (axis 1)."""
    if scheme == "contiguous":
        return x
    if scheme == "striped":
        return stripe_permute(x, factor)
    if scheme == "zigzag":
        return zigzag_permute(x, factor)
    raise ValueError(f"unknown sequence layout scheme {scheme!r}")


def layout_unpermute(x: torch.Tensor, scheme: str, factor: int) -> torch.Tensor:
    """Inverse of :func:`layout_permute`."""
    if scheme == "contiguous":
        return x
    if scheme == "striped":
        return stripe_unpermute(x, factor)
    if scheme == "zigzag":
        return zigzag_unpermute(x, factor)
    raise ValueError(f"unknown sequence layout scheme {scheme!r}")


def cut_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's data rows (axis 0) of a global batch; ``x`` itself
    with one data row (or no mesh)."""
    if mesh is None or mesh.data == 1:
        return x
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"batch {b} does not divide over {mesh.data} data rows")
    return x.narrow(0, mesh.data_rank * (b // mesh.data), b // mesh.data)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Inverse of :func:`cut_rows`: every row group's rows, gathered over
    the data ring."""
    if mesh is None or mesh.data == 1:
        return x
    return _GatherShards.apply(x, mesh.data_ring, 0)


def shard_cut(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's part of a global ``(batch, seq, ...)`` tensor laid
    out for the ring (padded and permuted): its data rows and the
    contiguous block of the (combined) seq ranks it holds.  ``x`` itself on
    a mesh that one process holds (or no mesh)."""
    x = cut_rows(x, mesh)
    if mesh is None or not mesh.seq_splits:
        return x
    ranks, n = mesh.seq_ranks, x.shape[1]
    _check_divides("shard_cut", n, mesh.seq)
    n_local = n // mesh.seq
    return x[:, ranks[0] * n_local:(ranks[-1] + 1) * n_local].contiguous()


def shard_gather(x: torch.Tensor, mesh, scheme: str = "contiguous",
                 factor: int = 1) -> torch.Tensor:
    """Inverse of :func:`shard_cut`, then of :func:`layout_permute`: the
    seq blocks gathered over the mesh's ring, the rows over its data ring,
    and the layout un-permuted.  Every process gets the same global tensor;
    its gradient reaches each process as its own slice (its consumer runs
    alike on every process, so the gradient is not summed over the ranks
    as ``Ring.all_gather``'s is).  On a factored mesh the blocks gather
    over the ulysses group first (the ring chunk), then over the ring."""
    if mesh is not None and mesh.seq_splits:
        for ring in (mesh.ulysses_ring, mesh.ring):
            if ring is not None and ring.spans_processes:
                x = _GatherShards.apply(x, ring, 1)
    return layout_unpermute(gather_rows(x, mesh), scheme, factor)


class _GatherShards(torch.autograd.Function):
    """One process's shard gathered over ``ring`` along ``dim``, for a
    consumer that every process runs alike: the backward keeps this
    process's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim, ctx.size = ring, dim, x.shape[dim]
        return ring.all_gather([(x.detach(),)], dim)[0][0]

    @staticmethod
    def backward(ctx, grad):
        start = ctx.ring.ranks[0] * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size), None, None
