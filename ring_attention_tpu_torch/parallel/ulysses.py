"""Ulysses sequence parallelism: all-to-all over heads.

Port of ``ring_attention_tpu/parallel/ulysses.py`` (``kv_head_reshard``
:31, ``ulysses_attention`` :88).  Two all-to-alls reshard the activations
from sequence-sharded to head-sharded and back; in between each rank
attends the whole sequence on its ``h / W`` query heads with the local
flash: ``impl="cuda"`` the CUDA kernels (the forward sweep, the dk/dv and
dq passes), ``impl="torch"`` the blockwise PyTorch path.

Where the JAX functions run under ``shard_map`` over a mesh axis, these
take a :class:`~.collectives.Ring` (the group the all-to-alls run over)
and the shards of the ranks this process holds, concatenated in rank order
along the sequence, as ``ring_flash_attention`` does: the whole sequence on
a ``VirtualRing``, the local shard on a ``DistributedRing``.  After the
all-to-all the held ranks' head blocks are folded into the batch dimension
(rank-major: batch row ``j * b + i`` is row ``i`` of held rank ``j``), so
that one launch attends for every rank this process holds: on a
``VirtualRing`` of ``W`` one launch over ``W * b`` rows of ``h / W`` heads,
the same work as the local model's launch over ``b`` rows of ``h`` heads.

GQA with ``hk % W != 0`` (small ``hk``) moves the real K/V heads once, an
all-gather along the sequence each, and picks each rank's kv head (or one
copy per query head where the head groups do not align) after it; the
gradient sums over the copies (the gather's backward and ``index_select``'s
scatter-add), as the JAX version's does through its transposes.
"""

from __future__ import annotations

import torch

from ..ops.attention import normalize_segment_ids
from ..ops.cuda_flash import cuda_flash_attention
from ..ops.flash import flash_attention
from ..utils.validate import check_attention_args
from .collectives import Ring

IMPLS = ("cuda", "torch")


def _check_heads(fn: str, h: int, world: int, what: str = "devices") -> None:
    if h % world:
        raise ValueError(f"{fn}: query heads {h} must divide over {world} {what}")


def to_heads(ring: Ring, x: torch.Tensor) -> torch.Tensor:
    """Sequence-sharded ``(b, h, n_held, d)`` to head-sharded: each held
    rank's ``(b, h / W, W * n_local, d)``, folded into the batch
    (``(count * b, h / W, W * n_local, d)``)."""
    count = len(ring.ranks)
    out = ring.all_to_all([(s,) for s in x.chunk(count, dim=2)], 1, 2)
    return torch.cat([o[0] for o in out], dim=0) if count > 1 else out[0][0]


def to_seq(ring: Ring, x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_heads`."""
    count = len(ring.ranks)
    out = ring.all_to_all([(s,) for s in x.chunk(count, dim=0)], 2, 1)
    return torch.cat([o[0] for o in out], dim=2) if count > 1 else out[0][0]


def gather_tokens(ring: Ring, x: torch.Tensor | None) -> torch.Tensor | None:
    """A per-token ``(b, n_held)`` tensor (key mask, segment ids) gathered
    along the sequence over ``ring`` for each held rank, folded into the
    batch as :func:`to_heads` folds the heads."""
    if x is None:
        return None
    count = len(ring.ranks)
    out = ring.all_gather([(s,) for s in x.chunk(count, dim=1)], 1)
    return torch.cat([o[0] for o in out], dim=0) if count > 1 else out[0][0]


def kv_head_reshard(k: torch.Tensor, v: torch.Tensor, ring: Ring,
                    h: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reshard K/V ``(b, hk, n_held, d)`` from sequence-sharded to
    head-sharded over ``ring`` for ``h`` query heads.

    ``hk % W == 0``: one all-to-all each for k and v; every rank ends with
    ``hk / W`` kv heads over the whole sequence.  Small-hk GQA: one
    all-gather each along the sequence (the real heads move once), then,
    where every query head of rank ``r`` shares one kv head (``h / W <= g``
    and ``g % (h / W) == 0``, ``g = h / hk``), that head sliced out; else one
    copy per local query head (``index_select``; group size 1).

    Returns ``(k, v)`` shaped ``(count * b, hk_local, W * n_local, d)``: the
    held ranks folded into the batch (:func:`to_heads`), local query head
    ``j`` reading kv head ``j // (h_local / hk_local)``."""
    hk = k.shape[1]
    world = ring.world
    if hk % world == 0:
        return to_heads(ring, k), to_heads(ring, v)
    _check_heads("kv_head_reshard", h, world)
    g, hql = h // hk, h // world
    count = len(ring.ranks)
    gathered = ring.all_gather([tuple(t.chunk(count, dim=2)[j] for t in (k, v))
                                for j in range(count)], 2)
    ks, vs = [], []
    for rank, (k_full, v_full) in zip(ring.ranks, gathered):
        if hql <= g and g % hql == 0:
            start = (rank * hql) // g
            ks.append(k_full[:, start:start + 1])
            vs.append(v_full[:, start:start + 1])
        else:
            idx = torch.div(rank * hql + torch.arange(hql, device=k.device), g,
                            rounding_mode="floor")
            ks.append(k_full.index_select(1, idx))
            vs.append(v_full.index_select(1, idx))
    if count == 1:
        return ks[0], vs[0]
    return torch.cat(ks, dim=0), torch.cat(vs, dim=0)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    ring: Ring,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    bucket_size: int | None = None,
    window: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    impl: str = "torch",
    segment_ids: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Head-parallel exact attention over ``ring``, differentiable.

    ``q: (b, h, n_held, d)``, ``k, v: (b, hk, n_held, d)``: the shards of
    the held ranks in rank order along the sequence, in the contiguous
    layout (head parallelism balances causal work by itself: Ulysses never
    stripes).  ``h % W == 0`` is required, each rank taking ``h / W`` query
    heads against the whole sequence.  ``kv_mask`` and ``segment_ids``
    (``(b, n_held)``, the ids used for queries and keys alike) are
    all-gathered along the sequence.  ``doc_starts`` declares a packing of
    the whole sequence (the local kernels' doc-tile tables under
    ``impl="cuda"``, runtime ids under ``"torch"``), in place of ids.
    ``impl``: ``"cuda"`` (JAX ``"pallas"``) or ``"torch"`` (JAX ``"xla"``;
    ``bucket_size`` is its tile).  Returns ``(b, h, n_held, d)`` in
    ``q.dtype``."""
    check_attention_args("ulysses_attention", q, k, v, kv_mask, equal_qkv_len=True,
                         shards=len(ring.ranks))
    seg, _ = normalize_segment_ids(
        None if segment_ids is None else (segment_ids, segment_ids), q, q,
        "ulysses_attention",
    )
    if impl not in IMPLS:
        raise ValueError(f"ulysses_attention: impl must be one of {IMPLS}, got {impl!r}")
    _check_heads("ulysses_attention", q.shape[1], ring.world)
    qh = to_heads(ring, q)
    kh, vh = kv_head_reshard(k, v, ring, q.shape[1])
    mask_full = gather_tokens(ring, kv_mask)
    seg_full = gather_tokens(ring, seg)
    kw = dict(causal=causal, window=window, softclamp_value=softclamp_value, scale=scale,
              segment_ids=seg_full, doc_starts=doc_starts)
    if impl == "cuda":
        out = cuda_flash_attention(qh, kh, vh, mask_full, **kw)
    else:
        out = flash_attention(qh, kh, vh, mask_full, bucket_size=bucket_size, **kw)
    return to_seq(ring, out)
