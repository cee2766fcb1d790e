"""Zig-zag context parallelism (Llama-3 style).

Port of ``ring_attention_tpu/parallel/zigzag.py:43-279``.  The sequence is
cut into ``2 * W`` chunks and ring rank ``r`` of ``W`` holds chunks ``(r,
2W-1-r)``, so that causal work is balanced over the ranks.  Attention
all-gathers K and V over the ring (``Ring.all_gather``, rank-major, so the
result is in zig-zag order), un-permutes them to the canonical order, and
attends each of the rank's two query chunks against the whole gathered span
with the band ``j - i <= causal_offset``, where ``causal_offset`` is the
chunk's global start (``r * chunk`` or ``(2W-1-r) * chunk``).  The band is
passed explicitly: an end-aligned causal call would be wrong here.

Two compute paths per chunk, each differentiable:

- ``impl="cuda"``: the CUDA kernels through ``ops/cuda_flash.py``'s
  autograd function (the port of the JAX ``_pallas_chunk_attention``
  custom_vjp): forward B1 in its fused mode (``flash_fwd`` with the
  chunk's ``causal_offset``: normalized output and lse in one sweep, where
  JAX runs partials then ``finalize_partials``, the same function), backward
  B2 (dk/dv) and B3 (dq) from ``(out, lse)`` with ``delta = (do * out).sum(-1)``;
- ``impl="torch"``: the blockwise PyTorch flash (``ops/flash.py``) with the
  same offset and its custom gradient.

The gradients of the gathered K and V flow back through the gather, the
counterpart of ``lax.all_gather``'s reduce-scatter transpose.  Segment ids
(packed sequences) are gathered and un-permuted with K and V and select the
kernels' segmented instantiation.
"""

from __future__ import annotations

import warnings

import torch

from ..ops.attention import normalize_segment_ids
from ..ops.cuda_flash import _CudaFlashAttention
from ..ops.flash import _FlashAttentionCore
from ..utils.validate import check_attention_args
from .collectives import Ring
from .ring import _fit_divisor

IMPLS = ("torch", "cuda")

# Warning threshold for the gathered K+V of one rank (bytes).  Zig-zag
# gathers the WHOLE global K and V onto every rank, an O(n_global) memory
# profile (JAX ``GATHERED_KV_BUDGET_BYTES``): ~537 MB a layer at 262,144
# tokens (hk 8, d 64, bf16) and 2.1 GB at 1M.  A chunked gather that
# accumulated online-softmax partials would be ring attention, which
# ``parallel/ring.py`` already runs in O(n_local) memory; when the warning
# fires, the answer is ``sequence_parallel="ring"``.
GATHERED_KV_BUDGET_BYTES = 2 * 1024**3


def _chunk_order(ring_size: int) -> list[int]:
    """The canonical chunk each position of the zig-zag layout holds:
    ``[0, 2W-1, 1, 2W-2, ...]``."""
    order = []
    for r in range(ring_size):
        order.extend([r, 2 * ring_size - 1 - r])
    return order


def _chunk_take(x: torch.Tensor, chunk_order: list[int], chunk: int, axis: int) -> torch.Tensor:
    """Reorder the ``len(chunk_order)`` chunks of ``chunk`` tokens along
    ``axis``: chunk ``i`` of the result is chunk ``chunk_order[i]`` of ``x``."""
    axis = axis % x.ndim
    shape = list(x.shape)
    x = x.reshape(shape[:axis] + [len(chunk_order), chunk] + shape[axis + 1:])
    index = torch.tensor(chunk_order, device=x.device)
    return x.index_select(axis, index).reshape(shape)


def _check_chunks(fn: str, n: int, ring_size: int) -> int:
    if n % (2 * ring_size):
        raise ValueError(
            f"{fn}: sequence {n} must divide into {2 * ring_size} chunks "
            f"(2 x ring {ring_size}); pad it to a multiple of {2 * ring_size}"
        )
    return n // (2 * ring_size)


def zigzag_permute(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """Reorder sequence chunks ``[0..2W)`` to ``[0, 2W-1, 1, 2W-2, ...]``:
    sharding the result contiguously over ``W`` ranks gives rank ``r``
    chunks ``(r, 2W-1-r)``."""
    chunk = _check_chunks("zigzag_permute", x.shape[axis], ring_size)
    return _chunk_take(x, _chunk_order(ring_size), chunk, axis)


def zigzag_unpermute(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_permute`."""
    chunk = _check_chunks("zigzag_unpermute", x.shape[axis], ring_size)
    inv = [0] * (2 * ring_size)
    for pos, c in enumerate(_chunk_order(ring_size)):
        inv[c] = pos
    return _chunk_take(x, inv, chunk, axis)


def zigzag_positions(n_local: int, rank: int, ring_size: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Global token positions ``(n_local,)`` of rank ``rank``'s zig-zag
    shard ``[chunk rank, chunk 2W-1-rank]``, for rotary."""
    chunk = n_local // 2
    i = torch.arange(chunk, device=device)
    return torch.cat([rank * chunk + i, (2 * ring_size - 1 - rank) * chunk + i])


def _chunk_attention(impl, qc, k_all, v_all, qc_seg, kv_seg, causal_offset,
                     scale, softclamp_value, bucket):
    """One query chunk against the gathered canonical K/V, differentiable."""
    if impl == "cuda":
        return _CudaFlashAttention.apply(
            qc.contiguous(), k_all, v_all, None, qc_seg, kv_seg, scale,
            causal_offset, None, softclamp_value, None,
        )
    return _FlashAttentionCore.apply(
        qc, k_all, v_all, None, qc_seg, kv_seg, causal_offset, scale, bucket,
        None, softclamp_value,
    )


def zigzag_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ring: Ring,
    *,
    causal: bool = True,
    bucket_size: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    impl: str = "torch",
    gathered_kv_budget: int | None = GATHERED_KV_BUDGET_BYTES,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Zig-zag sharded causal attention over ``ring``, differentiable.

    ``q: (b, h, n, d)``, ``k, v: (b, hk, n, d)``: the shards of the ranks
    this process holds (``ring.ranks``), in zig-zag layout (each shard is
    ``2 * chunk`` tokens), concatenated in rank order along the sequence:
    the whole zig-zag-permuted sequence on a ``VirtualRing``, the local
    shard on a ``DistributedRing``.  ``segment_ids``: optional ``(b, n)``
    document ids in the same layout.  ``impl``: ``"cuda"`` (B1, B2 and B3;
    their plain versions on CPU tensors) or ``"torch"`` (the blockwise
    PyTorch flash over tiles of ``bucket_size`` fitted to the gathered
    length).  ``gathered_kv_budget``: warn when the gathered K+V of one rank
    exceed this many bytes (None: never).  Returns ``(b, h, n, d)`` in
    ``q.dtype``, in the layout of ``q``."""
    if not causal:
        raise ValueError(
            "zigzag_attention: zig-zag context parallelism balances causal "
            "work; it is causal only"
        )
    if impl not in IMPLS:
        raise ValueError(f"zigzag_attention: impl must be one of {IMPLS}, got {impl!r}")
    count = len(ring.ranks)
    check_attention_args("zigzag_attention", q, k, v, equal_qkv_len=True, shards=count)
    seg, _ = normalize_segment_ids(
        None if segment_ids is None else (segment_ids, segment_ids), q, q,
        "zigzag_attention",
    )
    world = ring.world
    n_local = q.shape[2] // count
    if n_local % 2:
        raise ValueError(
            f"zigzag_attention: each rank's shard ({n_local} tokens) must hold "
            f"two equal chunks"
        )
    chunk = n_local // 2
    if scale is None:
        scale = q.shape[-1] ** -0.5
    gathered_bytes = 2 * (k.numel() // count) * world * k.element_size()
    if gathered_kv_budget is not None and gathered_bytes > gathered_kv_budget:
        warnings.warn(
            f"zigzag_attention gathers {gathered_bytes / 2**30:.2f} GiB of "
            f"global K+V onto every rank (O(n_global) by design) - over the "
            f"{gathered_kv_budget / 2**30:.2f} GiB budget. For long sequences "
            f"use sequence_parallel='ring' (O(n_local) memory) instead of "
            f"zig-zag",
            stacklevel=2,
        )
    gather = ring.all_gather if world > 1 else (lambda payloads, dim: payloads)
    kvs = gather(list(zip(k.chunk(count, dim=2), v.chunk(count, dim=2))), dim=2)
    segs = None if seg is None else seg.chunk(count, dim=1)
    seg_all = [None] * count if segs is None else gather([(s,) for s in segs], dim=1)
    canonical = {}  # one un-permute per distinct gathered payload
    outs = []
    for j, rank in enumerate(ring.ranks):
        key = id(kvs[j])
        if key not in canonical:
            # rank-major gather = zig-zag order: back to canonical order
            k_all, v_all = (zigzag_unpermute(x, world, axis=2).contiguous()
                            for x in kvs[j])
            kv_seg = (None if segs is None
                      else zigzag_unpermute(seg_all[j][0], world, axis=1).contiguous())
            canonical[key] = (k_all, v_all, kv_seg)
        k_all, v_all, kv_seg = canonical[key]
        bucket = _fit_divisor(bucket_size, k_all.shape[2]) if impl == "torch" else None
        q_r = q[:, :, j * n_local:(j + 1) * n_local]
        for which, start in enumerate((rank * chunk, (2 * world - 1 - rank) * chunk)):
            qc = q_r[:, :, which * chunk:(which + 1) * chunk]
            qc_seg = None
            if segs is not None:
                qc_seg = segs[j][:, which * chunk:(which + 1) * chunk].contiguous()
            outs.append(_chunk_attention(impl, qc, k_all, v_all, qc_seg, kv_seg,
                                         start, scale, softclamp_value, bucket))
    return torch.cat(outs, dim=2).to(q.dtype)
