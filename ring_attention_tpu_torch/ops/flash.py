"""Blockwise (flash) attention with an exposed online-softmax carry.

Port of ``ring_attention_tpu/ops/flash.py`` (the XLA blockwise path, not a
kernel).  ``attend_blocks`` folds one KV span into a running ``(acc, m, l)``
carry bucket by bucket; ``finalize`` normalizes it;
``flash_backward_blocks`` is the matching backward over one KV span;
``flash_attention`` is the single-device entry point, differentiated by a
custom gradient (the port of the ``_flash_attention_core`` custom_vjp) that
keeps ``(out, lse)`` and runs ``flash_backward_blocks`` instead of autograd
over the bucket loop.  The model's ``impl="torch"`` path and every
``prefill`` attend through it, as the JAX package's do.

Masking is one band of index offsets: local tile element ``(i, j)`` attends
iff ``window_lo <= j - i <= causal_offset`` (the lower bound only with a
lookback window), combined with an optional ``(b, nk)`` key mask and, for
packed sequences, per-token document ids (a query attends a key of its own
document only).  Masked scores take the finite ``MASK_VALUE``.  All softmax
state is float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .attention import (
    EPSILON,
    MASK_VALUE,
    PAD_SEGMENT_ID,
    doc_segment_ids,
    normalize_segment_ids,
    softclamp,
)
from .residuals import attention_pair
from ..utils.validate import check_attention_args


class FlashCarry(NamedTuple):
    """Running online-softmax state.

    acc: (b, hk, g, nq, d) float32 — unnormalized output accumulator
    m:   (b, hk, g, nq)    float32 — running row max
    l:   (b, hk, g, nq)    float32 — running row sum of exp(s - m)
    """

    acc: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def init_carry(
    b: int, hk: int, g: int, nq: int, d: int, device: torch.device | str = "cpu"
) -> FlashCarry:
    return FlashCarry(
        acc=torch.zeros((b, hk, g, nq, d), dtype=torch.float32, device=device),
        m=torch.full((b, hk, g, nq), MASK_VALUE, dtype=torch.float32, device=device),
        l=torch.zeros((b, hk, g, nq), dtype=torch.float32, device=device),
    )


def _group_q(q: torch.Tensor, hk: int) -> torch.Tensor:
    """(b, h, n, d) -> (b, hk, g, n, d) without repeating KV."""
    b, h, n, d = q.shape
    return q.reshape(b, hk, h // hk, n, d)


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    b, hk, g, n, d = x.shape
    return x.reshape(b, hk * g, n, d)


def _tile_scores(
    qg: torch.Tensor,  # (b, hk, g, nq, d)
    k: torch.Tensor,  # (b, hk, bk, d)
    scale: float,
    softclamp_value: float | None,
) -> torch.Tensor:
    s = torch.einsum("bhgid,bhjd->bhgij", qg.float(), k.float()) * scale
    if softclamp_value is not None:
        s = softclamp(s, softclamp_value)
    return s


def _tile_mask(
    nq: int,
    bk: int,
    j0: int,
    offset: int | None,
    window_lo: int | None,
    kv_mask_tile: torch.Tensor | None,
    device: torch.device,
    q_seg: torch.Tensor | None = None,  # (b, nq)
    kv_seg_tile: torch.Tensor | None = None,  # (b, bk)
) -> torch.Tensor | None:
    """Boolean (…, nq, bk) tile mask (True = attend), or None if unmasked.

    ``j0`` is the first local column of this KV tile; rows are the full
    local query range ``[0, nq)``."""
    masks = []
    if offset is not None:
        i = torch.arange(nq, device=device)[:, None]
        j = j0 + torch.arange(bk, device=device)[None, :]
        band = j <= i + offset
        if window_lo is not None:
            band = band & (j >= i + window_lo)
        masks.append(band)
    if kv_mask_tile is not None:
        masks.append(kv_mask_tile[:, None, None, None, :])  # (b, 1, 1, 1, bk)
    if q_seg is not None:  # packed sequences: the same document only
        masks.append(q_seg[:, None, None, :, None] == kv_seg_tile[:, None, None, None, :])
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def _online_update(carry: FlashCarry, s: torch.Tensor, v: torch.Tensor) -> FlashCarry:
    """Fold one score tile ``s: (b,hk,g,nq,bk)`` and values ``v: (b,hk,bk,d)``."""
    acc, m, l = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    # while a row has seen only masked scores, m_new is the sentinel and
    # exp(s - m) = 1: the masked keys average uniformly until a real score
    # arrives, whose rescale exp(sentinel - real) = 0 then wipes them
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bhgij,bhjd->bhgid", p, v.float())
    return FlashCarry(acc_new, m_new, l_new)


def _bucket_overlaps(q_seg, kv_seg, bk: int) -> list[bool] | None:
    """Per KV bucket of ``bk`` keys, whether its document ids' range meets
    the queries' (the JAX per-bucket ``segments_overlap``): disjoint ranges
    share no document, so such a bucket is skipped whole.  One host read
    per call; None without ids."""
    if q_seg is None:
        return None
    b, nk = kv_seg.shape
    tiles = kv_seg.reshape(b, nk // bk, bk)
    lo_q, hi_q = q_seg.min(), q_seg.max()
    lo_k, hi_k = tiles.amin(dim=(0, 2)), tiles.amax(dim=(0, 2))
    return ((lo_q <= hi_k) & (lo_k <= hi_q)).tolist()


def attend_blocks(
    q: torch.Tensor,  # (b, h, nq, d)
    k: torch.Tensor,  # (b, hk, nk, d)
    v: torch.Tensor,  # (b, hk, nk, d)
    carry: FlashCarry,
    *,
    scale: float,
    bucket_size: int | None = None,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    kv_mask: torch.Tensor | None = None,  # (b, nk) True = attend
    softclamp_value: float | None = None,
    q_segment_ids: torch.Tensor | None = None,  # (b, nq) int32
    kv_segment_ids: torch.Tensor | None = None,  # (b, nk) int32
) -> FlashCarry:
    """Fold one KV span into the running carry, bucket by bucket.

    ``window_lo`` is the band's absolute lower offset (attend iff
    ``window_lo <= j - i <= causal_offset``); for a contiguous layout with a
    token window ``w`` it is ``causal_offset - (w - 1)``.

    ``q_segment_ids``/``kv_segment_ids`` restrict attention to matching
    document ids (packed sequences); a bucket whose id range shares no
    document with the queries is skipped whole, leaving the carry as a
    fully masked bucket would (its weights are wiped by the next rescale)."""
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    qg = _group_q(q, hk)
    bk = nk if bucket_size is None or bucket_size >= nk else bucket_size
    if nk % bk:
        raise ValueError(f"kv length {nk} must divide into buckets of {bk}")
    # as in JAX, a span taken as one bucket is never skipped (its rows with
    # no key of their document average V, as the dense oracle's do)
    overlaps = _bucket_overlaps(q_segment_ids, kv_segment_ids, bk) if bk < nk else None
    for t, j0 in enumerate(range(0, nk, bk)):
        if overlaps is not None and not overlaps[t]:
            continue
        s = _tile_scores(qg, k[:, :, j0:j0 + bk], scale, softclamp_value)
        mask = _tile_mask(
            nq, bk, j0, causal_offset, window_lo,
            None if kv_mask is None else kv_mask[:, j0:j0 + bk], q.device,
            q_segment_ids,
            None if kv_segment_ids is None else kv_segment_ids[:, j0:j0 + bk],
        )
        if mask is not None:
            s = torch.where(mask, s, MASK_VALUE)
        carry = _online_update(carry, s, v[:, :, j0:j0 + bk])
    return carry


def finalize(carry: FlashCarry) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize the carry: ``out (b,hk,g,nq,d)`` f32 and ``lse (b,hk,g,nq)``."""
    acc, m, l = carry
    l_safe = torch.clamp(l, min=EPSILON)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def flash_backward_blocks(
    do: torch.Tensor,  # (b, h, nq, d)
    q: torch.Tensor,
    k: torch.Tensor,  # (b, hk, nk, d)
    v: torch.Tensor,
    lse: torch.Tensor,  # (b, hk, g, nq) f32
    delta: torch.Tensor,  # (b, hk, g, nq) f32 = rowsum(do * out)
    *,
    scale: float,
    bucket_size: int | None = None,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    kv_mask: torch.Tensor | None = None,  # (b, nk) True = attend
    softclamp_value: float | None = None,
    q_segment_ids: torch.Tensor | None = None,  # (b, nq) int32
    kv_segment_ids: torch.Tensor | None = None,  # (b, nk) int32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward over one KV span, bucket by bucket.

    Returns float32 ``(dq (b, h, nq, d), dk (b, hk, nk, d), dv (b, hk, nk,
    d))``.  ``p`` is recomputed from ``lse`` and masked by a select, so a
    row with no key in its band contributes nothing.  Segment ids mask
    cross-document pairs out of ``p``, and a bucket sharing no document
    with the queries skips straight to zero dk/dv (the forward's skip)."""
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    qg = _group_q(q, hk).float()
    dog = _group_q(do, hk).float()
    bk = nk if bucket_size is None or bucket_size >= nk else bucket_size
    if nk % bk:
        raise ValueError(f"kv length {nk} must divide into buckets of {bk}")
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    overlaps = _bucket_overlaps(q_segment_ids, kv_segment_ids, bk)
    for t, j0 in enumerate(range(0, nk, bk)):
        if overlaps is not None and not overlaps[t]:
            zeros = torch.zeros((b, hk, bk, d), dtype=torch.float32, device=q.device)
            dks.append(zeros)
            dvs.append(zeros)
            continue
        k_j = k[:, :, j0:j0 + bk].float()
        v_j = v[:, :, j0:j0 + bk].float()
        s = _tile_scores(qg, k_j, scale, softclamp_value)
        mask = _tile_mask(
            nq, bk, j0, causal_offset, window_lo,
            None if kv_mask is None else kv_mask[:, j0:j0 + bk], q.device,
            q_segment_ids,
            None if kv_segment_ids is None else kv_segment_ids[:, j0:j0 + bk],
        )
        p = torch.exp(s - lse[..., None])  # (b, hk, g, nq, bk)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dvs.append(torch.einsum("bhgij,bhgid->bhjd", p, dog))
        dp = torch.einsum("bhgid,bhjd->bhgij", dog, v_j)
        ds = p * (dp - delta[..., None])
        if softclamp_value is not None:
            # s is post-clamp; d(clamp)/d(raw) = 1 - (s/c)^2
            ds = ds * (1.0 - (s / softclamp_value) ** 2)
        ds = ds * scale
        dks.append(torch.einsum("bhgij,bhgid->bhjd", ds, qg))
        dq = dq + torch.einsum("bhgij,bhjd->bhgid", ds, k_j)
    return _ungroup(dq), torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


class _FlashAttentionCore(torch.autograd.Function):
    """Port of the ``_flash_attention_core`` custom_vjp: the forward keeps
    ``(out, lse)`` (the residuals ``flash_out`` / ``flash_lse`` that a
    ``save_attn`` region keeps, ``ops/residuals.py``), the backward runs
    :func:`flash_backward_blocks`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_seg, kv_seg, causal_offset, scale,
                bucket_size, window_lo, softclamp_value):
        b, h, nq, d = q.shape
        hk = k.shape[1]
        band = dict(scale=scale, bucket_size=bucket_size,
                    causal_offset=causal_offset, window_lo=window_lo,
                    softclamp_value=softclamp_value)

        def sweep():
            carry = init_carry(b, hk, h // hk, nq, d, device=q.device)
            carry = attend_blocks(q, k, v, carry, kv_mask=kv_mask, q_segment_ids=q_seg,
                                  kv_segment_ids=kv_seg, **band)
            out_g, lse = finalize(carry)
            return _ungroup(out_g).to(q.dtype), lse

        out, lse = attention_pair(sweep)
        ctx.save_for_backward(q, k, v, kv_mask, q_seg, kv_seg, out, lse)
        ctx.band = band
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, q_seg, kv_seg, out, lse = ctx.saved_tensors
        hk = k.shape[1]
        delta = (_group_q(do, hk).float() * _group_q(out, hk).float()).sum(-1)
        dq, dk, dv = flash_backward_blocks(
            do, q, k, v, lse, delta, kv_mask=kv_mask, q_segment_ids=q_seg,
            kv_segment_ids=kv_seg, **ctx.band
        )
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    bucket_size: int | None = None,
    window: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    segment_ids=None,
    doc_starts: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Single-device exact flash attention (GQA-aware), differentiable.

    Matches ``default_attention``; score memory scales with ``bucket_size``
    instead of ``nk``.  Any KV length is accepted: a length that is not a
    multiple of ``bucket_size`` is padded with masked-out slots.  The causal
    band is end-aligned (``offset = nk - nq``), so decode-style ``nq < nk``
    calls match the oracle.  ``window`` (causal only) keeps the last
    ``window`` keys of each query, its own included.

    ``segment_ids`` enables packed-sequence attention: a ``(b, n)`` tensor
    of per-token document ids (or a ``(q_ids, kv_ids)`` pair), masking
    cross-document logits to exactly zero weight and skipping KV buckets
    that share no document with the queries.  ``doc_starts`` declares the
    packing instead (the sorted start offsets of the documents of every
    row, ``nq == nk``), realized here as those runtime ids, as the JAX
    ``attention`` realizes it for its XLA path."""
    check_attention_args("flash_attention", q, k, v, mask)
    segment_ids = doc_segment_ids("flash_attention", segment_ids, doc_starts, q, k)
    q_seg, kv_seg = normalize_segment_ids(segment_ids, q, k, "flash_attention")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and not causal:
        raise ValueError("flash_attention: lookback windows require causal attention")
    if causal:
        mask = None  # causal and a key-padding mask are exclusive
    causal_offset = k.shape[2] - q.shape[2] if causal else None
    # computed from the real nk: pad keys sit at j >= nk > i + offset
    window_lo = causal_offset - (window - 1) if window is not None else None
    k, v, mask, kv_seg = _pad_kv_to_bucket(q, k, v, mask, kv_seg, bucket_size)

    return _FlashAttentionCore.apply(
        q, k, v, mask, q_seg, kv_seg, causal_offset, scale, bucket_size,
        window_lo, softclamp_value,
    )


def _pad_kv_to_bucket(q, k, v, mask, kv_seg, bucket_size):
    nk = k.shape[2]
    if bucket_size is None or nk % bucket_size == 0:
        return k, v, mask, kv_seg
    pad = bucket_size - nk % bucket_size
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if mask is None:
        mask = torch.arange(nk + pad, device=k.device)[None, :] < nk
        mask = mask.expand(q.shape[0], nk + pad)
    else:
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    if kv_seg is not None:
        kv_seg = torch.nn.functional.pad(kv_seg, (0, pad), value=PAD_SEGMENT_ID)
    return k, v, mask, kv_seg
