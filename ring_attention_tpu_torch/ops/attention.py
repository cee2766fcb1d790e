"""Dense attention oracle in plain PyTorch.

Port of ``ring_attention_tpu/ops/attention.py``: exact, score-materializing
attention used as the ground truth of the port's tests and as the decode
attention of the ``impl="torch"`` path.

Layout at every public function: ``q: (b, h, n, d)``, ``k, v: (b, hk, n, d)``
(heads-major, as in the JAX package).  Query head ``j`` reads kv head
``j // (h // hk)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.validate import check_attention_args, check_segment_ids

# Large-but-finite mask value: -inf would make a fully masked row NaN
# (exp(-inf - -inf)); with a finite value such a row averages V uniformly.
MASK_VALUE = -0.5 * float(torch.finfo(torch.float32).max)
EPSILON = 1e-10

# Segment id reserved for padding: never equal to a real document id (real
# ids are >= 0), so pad queries and keys attend only each other.
PAD_SEGMENT_ID = -1


class SegmentIds(NamedTuple):
    """Per-token document ids of packed sequences.

    A query at row ``i`` attends a key at column ``j`` only when ``q[.., i]
    == kv[.., j]``, on top of the band, the key mask and the window.  Real
    ids are ``>= 0``; ``PAD_SEGMENT_ID`` marks padding."""

    q: torch.Tensor  # (b, nq) int32
    kv: torch.Tensor  # (b, nk) int32


def normalize_segment_ids(segment_ids, q, k, fn: str = "attention"):
    """``(q_seg, kv_seg)`` int32 tensors from the public ``segment_ids``
    argument: a ``(b, n)`` tensor used for both sides (``nq == nk``), a
    ``(q_ids, kv_ids)`` pair or :class:`SegmentIds`, or None -> ``(None,
    None)``.  Validated against ``q`` and ``k``; on their device, contiguous."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
    else:
        q_seg = kv_seg = segment_ids
    q_seg, kv_seg = (torch.as_tensor(s, device=q.device) for s in (q_seg, kv_seg))
    check_segment_ids(fn, q, k, q_seg, kv_seg)
    return (q_seg.to(torch.int32).contiguous(), kv_seg.to(torch.int32).contiguous())


def check_doc_starts(doc_starts, nq: int, nk: int) -> tuple[int, ...]:
    """Validate a declared packing layout: sorted unique int document start
    offsets beginning at 0, shared by queries and keys (``nq == nk``), as
    ``pallas_flash._check_doc_starts`` (:381) with its messages."""
    if nq != nk:
        raise ValueError(
            f"doc_starts declares one packing layout for q AND kv, which "
            f"needs nq == nk, got ({nq}, {nk})"
        )
    ds = tuple(int(s) for s in doc_starts)
    if not ds or ds[0] != 0 or list(ds) != sorted(set(ds)) or ds[-1] >= nk:
        raise ValueError(
            f"doc_starts must be sorted unique offsets starting at 0 and "
            f"< {nk}, got {doc_starts!r}"
        )
    return ds


def doc_runtime_ids(doc_starts, n: int, batch: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """``(batch, n)`` int32 document ids realizing a declared layout
    (``pallas_flash._doc_runtime_ids``, :416): the runtime-ids form of a
    layout that a pass's blocks do not align, and of the paths with no
    tables."""
    starts = torch.tensor(doc_starts, dtype=torch.int64, device=device)
    ids = torch.searchsorted(starts, torch.arange(n, device=device), right=True) - 1
    return ids.to(torch.int32)[None, :].expand(batch, n).contiguous()


def doc_segment_ids(fn: str, segment_ids, doc_starts, q, k):
    """``segment_ids`` of a call, or a declared packing ``doc_starts`` (the
    sorted start offsets of the documents of every row, ``nq == nk``)
    realized as ``(b, n)`` runtime ids: a path with no tile tables masks the
    documents with ids, never drops them.  Both given raise."""
    if doc_starts is None:
        return segment_ids
    if segment_ids is not None:
        raise ValueError(f"{fn}: doc_starts and segment_ids both declare the packing; pass one")
    starts = check_doc_starts(doc_starts, q.shape[2], k.shape[2])
    return doc_runtime_ids(starts, q.shape[2], q.shape[0], q.device)


def segments_overlap(q_seg: torch.Tensor, kv_seg: torch.Tensor) -> bool:
    """Conservative "any shared document?" test of two id blocks: disjoint
    id ranges share no document whatever their order, so skipping on a
    False is always sound (overlapping ranges may still share nothing; the
    per-element mask handles those).  Reads two scalars to the host."""
    lo_q, hi_q, lo_k, hi_k = torch.stack(
        [q_seg.min(), q_seg.max(), kv_seg.min(), kv_seg.max()]).tolist()
    return lo_q <= hi_k and lo_k <= hi_q


def softclamp(x: torch.Tensor, value: float) -> torch.Tensor:
    """Soft clamp logits to (-value, value) via tanh (Gemma-style capping)."""
    return torch.tanh(x / value) * value


def default_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    softclamp_value: float | None = None,
    segment_ids=None,
    doc_starts: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Exact dense attention.

    Args:
      q: ``(b, h, nq, d)`` queries.
      k: ``(b, hk, nk, d)`` keys; ``h`` must be a multiple of ``hk`` (GQA).
      v: ``(b, hk, nk, d)`` values.
      mask: optional ``(b, nk)`` boolean key-padding mask, True = attend.
      causal: end-aligned causal mask (query ``i`` sees keys
        ``j <= i + nk - nq``); ``mask`` is ignored when set.
      softclamp_value: if set, logits are soft-clamped to this magnitude.
      segment_ids: packed-sequence document ids (see
        :func:`normalize_segment_ids`); composes with every other mask:
        cross-document logits are masked out.
      doc_starts: a declared packing instead of ``segment_ids`` (see
        :func:`doc_segment_ids`), masked as those ids.

    Returns:
      ``(b, h, nq, d)`` attention output in ``q.dtype``.
    """
    check_attention_args("default_attention", q, k, v, mask)
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    g = h // hk
    segment_ids = doc_segment_ids("default_attention", segment_ids, doc_starts, q, k)
    q_seg, kv_seg = normalize_segment_ids(segment_ids, q, k, "default_attention")

    scale = d**-0.5
    qg = q.reshape(b, hk, g, nq, d).float()
    sim = torch.einsum("bhgid,bhjd->bhgij", qg, k.float()) * scale

    if softclamp_value is not None:
        sim = softclamp(sim, softclamp_value)

    if causal:
        i = torch.arange(nq, device=q.device)[:, None]
        j = torch.arange(nk, device=q.device)[None, :]
        sim = torch.where(j <= i + (nk - nq), sim, MASK_VALUE)
    elif mask is not None:
        sim = torch.where(mask[:, None, None, None, :], sim, MASK_VALUE)

    if q_seg is not None:
        same = q_seg[:, None, None, :, None] == kv_seg[:, None, None, None, :]
        sim = torch.where(same, sim, MASK_VALUE)

    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhgij,bhjd->bhgid", attn, v.float())
    return out.reshape(b, h, nq, d).to(q.dtype)
