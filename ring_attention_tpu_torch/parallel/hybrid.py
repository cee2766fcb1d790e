"""Hybrid Ulysses x Ring sequence parallelism on the factored mesh.

Port of ``ring_attention_tpu/parallel/hybrid.py::hybrid_attention``
(:45-150).  The sequence world factors as ``R * U``, sharded ring-major,
ulysses-minor: rank ``(r, u)`` holds subchunk ``u`` of ring chunk ``r``.
Three stages a layer:

1. an all-to-all over the ulysses group (``parallel/ulysses.py``): each
   rank trades its subchunk for ``h / U`` query heads over its whole ring
   chunk (K/V through ``kv_head_reshard``: small-hk GQA gathers the real
   heads once); the key mask and the segment ids are all-gathered to the
   ring chunk;
2. ``parallel/ring.py::ring_flash_attention`` over the OUTER ring of ``R``
   on that head subset, with every ring knob sized against the ring chunk
   (``n / R``): ``R`` hops where a pure ring of ``R * U`` takes ``R * U``;
3. the all-to-all back.

Composition, no new gradient: the all-to-alls and the ring carry theirs.
``striped`` is the OUTER ring's layout (stripe factor ``R``), and rotary
positions are the caller's (``ops/rotary.py::hybrid_positions``).

The functions take the mesh's two rings, :class:`~.collectives.Ring`
objects, and the shards of the combined ranks this process holds in rank
order along the sequence: the whole sequence in one process (a
``VirtualRing(U)`` and a ``VirtualRing(R)``), one shard on a process of a
``(data, ring, ulysses)`` process mesh.  In one process the ``U`` outer
rings are folded into the batch dimension of ONE ring of ``R`` (after the
all-to-all every ulysses index holds ``h / U`` heads over the same chunk
length), so that each of the ring's launches serves all of them: the
launch counts of a ring of ``R`` over ``U * b`` rows.

``impl`` (``"torch"``, ``"cuda"``, ``"fused"``) and every ring knob
(``bidirectional``, ``counter_rotate``, ``dkv_dtype``, ``hop_compression``,
``compute_dtype``) pass through to the outer ring and mean what they mean
there (JAX :61-64, :141-142).
"""

from __future__ import annotations

import torch

from ..ops.attention import normalize_segment_ids
from ..utils.validate import check_attention_args
from .collectives import Ring
from .ring import ring_flash_attention
from .ulysses import gather_tokens, kv_head_reshard, to_heads, to_seq


def hybrid_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None,
    ulysses_ring: Ring,
    ring: Ring,
    *,
    causal: bool = False,
    striped: bool = False,
    bucket_size: int | None = None,
    max_ring_passes: int | None = None,
    window: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    impl: str = "torch",
    bidirectional: bool = False,
    dkv_dtype: str | None = None,
    segment_ids: torch.Tensor | None = None,
    counter_rotate: bool = False,
    hop_compression: str | None = None,
    compute_dtype: str | None = None,
) -> torch.Tensor:
    """2-D factored sequence-parallel exact attention, differentiable.

    ``q: (b, h, n_held, d)``, ``k, v: (b, hk, n_held, d)``, ``kv_mask`` and
    ``segment_ids`` ``(b, n_held)``: the held combined ranks' shards in rank
    order along the sequence.  ``h`` must divide over the ulysses group.
    The ring knobs (``bucket_size``, ``max_ring_passes``, ``window``) read
    ``n_local`` as the ring chunk, ``U`` times the resident shard.  Returns
    ``(b, h, n_held, d)`` in ``q.dtype``."""
    chunks = len(ring.ranks)
    check_attention_args("hybrid_attention", q, k, v, kv_mask, equal_qkv_len=True,
                         shards=chunks * len(ulysses_ring.ranks))
    seg, _ = normalize_segment_ids(
        None if segment_ids is None else (segment_ids, segment_ids), q, q,
        "hybrid_attention",
    )
    h, u = q.shape[1], ulysses_ring.world
    if h % u:
        raise ValueError(
            f"hybrid_attention: query heads {h} must divide over the {u}-device ulysses axis"
        )

    def per_chunk(fn, x, dim=2):
        # the held ring chunks one by one (each its ulysses group's shards)
        if x is None:
            return None
        parts = [fn(c) for c in x.chunk(chunks, dim=dim)]
        return torch.cat(parts, dim=dim) if chunks > 1 else parts[0]

    qh = per_chunk(lambda c: to_heads(ulysses_ring, c), q)
    kvs = [kv_head_reshard(kc, vc, ulysses_ring, h)
           for kc, vc in zip(k.chunk(chunks, dim=2), v.chunk(chunks, dim=2))]
    kh, vh = (torch.cat(t, dim=2) if chunks > 1 else t[0] for t in zip(*kvs))
    mask_c = per_chunk(lambda c: gather_tokens(ulysses_ring, c), kv_mask, dim=1)
    seg_c = per_chunk(lambda c: gather_tokens(ulysses_ring, c), seg, dim=1)
    out = ring_flash_attention(
        qh, kh, vh, mask_c, ring, causal, striped, bucket_size, max_ring_passes, window,
        softclamp_value, scale, impl, bidirectional, dkv_dtype, segment_ids=seg_c,
        counter_rotate=counter_rotate, hop_compression=hop_compression,
        compute_dtype=compute_dtype,
    )
    return per_chunk(lambda c: to_seq(ulysses_ring, c), out)
