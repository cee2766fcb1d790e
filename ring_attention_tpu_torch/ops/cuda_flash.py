"""Flash attention on the hand-written CUDA kernels ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` and ``csrc/flash_decode.cu``.

Host side of the ports of ``ring_attention_tpu/ops/pallas_flash.py``: the
forward sweep ``_flash_fwd_call`` (:869-1193) in its three modes and the
two passes of ``pallas_flash_backward`` (dk/dv and dq):

- ``flash_fwd`` (fused: normalized output + lse, optionally resuming a
  carry, as ``pallas_flash_fused``), ``flash_partials`` (raw f32
  ``(acc, m, l)`` from no carry or a carry, as ``pallas_flash_partials``)
  and ``flash_bwd`` are the kernel wrappers.  A CUDA tensor launches the
  kernels (or raises); a CPU tensor runs ``flash_fwd_reference`` /
  ``flash_partials_reference`` / ``flash_bwd_reference``, the plain
  versions of the same functions.  Nothing else selects between the two.
- ``cuda_flash_attention`` mirrors ``pallas_flash_attention`` (:2281) with
  its custom gradient (``_pallas_flash_core``, :2213-2278): the forward
  keeps ``(out, lse)`` and the backward runs both passes from them.
- ``cuda_flash_decode`` mirrors ``pallas_flash_decode`` (:1340), fused
  or as partials: the GQA group folds onto query rows so each cache byte is
  read once per kv head, and the keys split into ranges that the split-KV
  decode kernel sweeps in parallel and merges; ``flash_decode_reference``
  is its plain version, split and merged the same way.
- ``compute_dtype="int8"`` on ``flash_fwd``, ``flash_partials`` and
  ``cuda_flash_attention`` runs the sweep's int8 mode instead, the
  separate kernel of ``cuda_flash_q8.py``; the backward stays here.
- ``q_seg``/``kv_seg`` (packed sequences, ``_flash_fwd_call(q_segment_ids=,
  kv_segment_ids=)`` and ``pallas_flash_backward(segment_ids=)``): int32
  ``(b, nq)`` and ``(b, nk)`` document ids; a pair attends only within one
  document.  They select the kernels' segmented instantiation, which
  visits the same tiles as the unsegmented one (no tile is skipped on
  ids, as the TPU kernel skips none on runtime ids); so does the int8
  sweep's.
- ``doc_starts`` (a declared packing, ``pallas_flash_attention(doc_starts=)``
  and the per-pass tables of ``pallas_flash_backward``, :1966-2009): the
  sorted start offsets of the documents, one layout for queries and keys.
  On a causal band whose documents start on a pass's own blocks
  (``DOC_BLOCKS``), that pass drops every tile of another document: one
  host function, :func:`doc_tile_ranges`, gives each block the tiles it
  visits, a small int32 table that the kernel's third instantiation
  (kDocs) takes instead of ids.  Otherwise the pass realizes the layout as
  runtime ids (the segmented instantiation, counted as such).  The layout
  is part of the function, never dropped: on CPU tensors the plain
  versions take it as ids.

On the card the bf16 forward sweep and both bf16 backward passes run on
Hopper's warpgroup products (wgmma) over 128-byte-swizzled tiles streamed
by cp.async (``csrc/wgmma.cuh``): the sweep and dq take 128 query rows a
block in two warpgroups of 64, dk/dv 128 keys.  Their sums run in another
order than the plain versions', so the card holds them to the plain
versions within the bounds that ``chip_smoke.py`` states; the f32
instantiations run on CUDA cores and follow the plain versions to float32
rounding.

``launch_count`` counts every launch of the forward kernel;
``seed_launch_count``, ``resume_launch_count`` and
``fused_carry_launch_count`` count its ring modes (partials from no carry,
partials from a carry, out + lse from a carry); ``dkv_launch_count`` and
``dq_launch_count`` count the backward kernels; ``decode_launch_count``
counts the decode kernel; ``seg_launch_count``,
``seg_dkv_launch_count`` and ``seg_dq_launch_count`` count again those of
the three launches that took document ids; ``doc_launch_count``,
``doc_dkv_launch_count`` and ``doc_dq_launch_count`` those that took a
declared packing's doc-tile table.  Plain-version calls do not count, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import bisect
import ctypes
import functools

import numpy as np
import torch

from .attention import (
    MASK_VALUE,
    check_doc_starts,
    doc_runtime_ids,
    normalize_segment_ids,
    softclamp,
)
from .partials import FlashPartials, finalize_partials, init_partials
from .residuals import attention_pair
from ..utils.validate import check_attention_args

SUPPORTED_HEAD_DIMS = (64,)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset; the caller may set them to 0.
launch_count = 0  # flash_fwd, every mode
seed_launch_count = 0  # flash_fwd writing partials, no carry
resume_launch_count = 0  # flash_fwd writing partials from a carry
fused_carry_launch_count = 0  # flash_fwd writing out + lse from a carry
dkv_launch_count = 0  # flash_bwd_dkv
dq_launch_count = 0  # flash_bwd_dq
decode_launch_count = 0  # flash_decode
# The same launches, counted again when they ran the segmented instantiation.
seg_launch_count = 0  # flash_fwd, every mode
seg_dkv_launch_count = 0  # flash_bwd_dkv
seg_dq_launch_count = 0  # flash_bwd_dq
# And again when they took a declared packing's doc-tile table.
doc_launch_count = 0  # flash_fwd, every mode
doc_dkv_launch_count = 0  # flash_bwd_dkv
doc_dq_launch_count = 0  # flash_bwd_dq


def _keep(nq, nk, kv_mask, causal_offset, window_lo, device, q_seg=None,
          kv_seg=None) -> torch.Tensor:
    """Boolean ``(b|1, 1, 1, nq, nk)`` keep mask of the band, the key mask
    and the document ids."""
    keep = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal_offset is not None:
        off = (torch.arange(nk, device=device)[None, :]
               - torch.arange(nq, device=device)[:, None])
        keep = off <= causal_offset
        if window_lo is not None:
            keep = keep & (off >= window_lo)
    keep = keep[None, None, None]
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, None, :]
    if q_seg is not None:
        keep = keep & (q_seg[:, None, None, :, None] == kv_seg[:, None, None, None, :])
    return keep


def flash_partials_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    carry: FlashPartials | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
) -> FlashPartials:
    """Plain PyTorch version of the kernel's partials modes: the span folded
    into ``carry`` (``init_partials`` when None) with dense f32 scores.

    Local element ``(i, j)`` attends iff ``window_lo <= j - i <=
    causal_offset`` (each bound only when given), ``kv_mask[b, j]`` and,
    with ids, ``q_seg[b, i] == kv_seg[b, j]``; masked scores take the
    finite ``MASK_VALUE``, so a row that has seen no key averages V over
    every key until a real score wipes that out."""
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    g = h // hk
    if carry is None:
        carry = init_partials(b, h, nq, d, device=q.device)
    qg = q.reshape(b, hk, g, nq, d).float()
    s = torch.einsum("bhgid,bhjd->bhgij", qg, k.float()) * scale
    if softclamp_value is not None:
        s = softclamp(s, softclamp_value)
    keep = _keep(nq, nk, kv_mask, causal_offset, window_lo, q.device, q_seg, kv_seg)
    s = torch.where(keep, s, MASK_VALUE)
    m_c = carry.m.reshape(b, hk, g, nq)
    m = torch.maximum(m_c, s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    alpha = torch.exp(m_c - m)
    l = carry.l.reshape(b, hk, g, nq) * alpha + p.sum(dim=-1)
    acc = (carry.acc.reshape(b, hk, g, nq, d) * alpha[..., None]
           + torch.einsum("bhgij,bhjd->bhgid", p, v.float()))
    return FlashPartials(acc.reshape(b, h, nq, d), m.reshape(b, h, nq),
                         l.reshape(b, h, nq))


def flash_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    carry: FlashPartials | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's fused mode: the partials of
    :func:`flash_partials_reference`, normalized.  Returns ``(out (b, h,
    nq, d) in q.dtype, lse (b, h, nq) f32)``."""
    out, lse = finalize_partials(flash_partials_reference(
        q, k, v, kv_mask, scale=scale, causal_offset=causal_offset,
        window_lo=window_lo, softclamp_value=softclamp_value, carry=carry,
        q_seg=q_seg, kv_seg=kv_seg,
    ))
    return out.to(q.dtype), lse


def flash_bwd_reference(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: dense scores in float32.

    ``do, q: (b, h, nq, d)``, ``k, v: (b, hk, nk, d)``, ``lse`` (the
    forward's) and ``delta = rowsum(do * out)``: ``(b, h, nq)`` float32.
    The band, key mask and ids follow :func:`flash_fwd_reference`; a masked pair
    takes ``p = 0`` by a select, so a row with no key contributes nothing.
    Returns float32 ``(dq (b, h, nq, d), dk (b, hk, nk, d), dv (b, hk, nk,
    d))``, dk and dv summed over each kv head's group of query heads."""
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    g = h // hk
    qg = q.reshape(b, hk, g, nq, d).float()
    dog = do.reshape(b, hk, g, nq, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgid,bhjd->bhgij", qg, kf) * scale
    if softclamp_value is not None:
        s = softclamp(s, softclamp_value)
    keep = _keep(nq, nk, kv_mask, causal_offset, window_lo, q.device, q_seg, kv_seg)
    p = torch.where(keep, torch.exp(s - lse.reshape(b, hk, g, nq, 1)), 0.0)
    dv = torch.einsum("bhgij,bhgid->bhjd", p, dog)
    dp = torch.einsum("bhgid,bhjd->bhgij", dog, vf)
    ds = p * (dp - delta.reshape(b, hk, g, nq, 1))
    if softclamp_value is not None:
        ds = ds * (1.0 - (s / softclamp_value) ** 2)  # s is post-clamp
    ds = ds * scale
    dk = torch.einsum("bhgij,bhgid->bhjd", ds, qg)
    dq = torch.einsum("bhgij,bhjd->bhgid", ds, kf)
    return dq.reshape(b, h, nq, d), dk, dv


def _check_kernel_args(fn, q, k, v, kv_mask, *rows, dtypes=SUPPORTED_DTYPES,
                       segs=(None, None)) -> None:
    """What the kernels take; ``rows`` are further ``(b, h, nq, ...)``
    inputs (``do`` in q's dtype, ``lse`` and ``delta`` in float32),
    ``dtypes`` the operand types the kernel is built for and ``segs`` the
    ``(q_seg, kv_seg)`` ids, both None or int32 ``(b, nq)`` and ``(b, nk)``."""
    if q.dtype not in dtypes:
        raise ValueError(f"{fn}: dtype {q.dtype} unsupported; use one of {dtypes}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{fn}: q, k, v must share a dtype, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"{fn}: head dim {q.shape[-1]} unsupported; the kernel is "
            f"built for {SUPPORTED_HEAD_DIMS}"
        )
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"{fn}: empty query or key sequence")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{fn}: batch * heads exceeds the grid's 65535 rows")
    q_seg, kv_seg = segs
    if (q_seg is None) != (kv_seg is None):
        raise ValueError(f"{fn}: q_seg and kv_seg go together")
    if q_seg is not None:
        rows += ((q_seg, (q.shape[0], q.shape[2]), torch.int32),
                 (kv_seg, (k.shape[0], k.shape[2]), torch.int32))
    for x, shape, dtype in rows:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"{fn}: expected {shape} {dtype}, got {tuple(x.shape)} {x.dtype}"
            )
    tensors = [q, k, v] + [x for x, _, _ in rows]
    for x in tensors + ([kv_mask] if kv_mask is not None else []):
        if x.device != q.device:
            raise ValueError(f"{fn}: tensors on {x.device} and {q.device}")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"{fn}: every input must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: every input must be 16-byte aligned")


def _band_args(causal_offset, window_lo, softclamp_value) -> tuple:
    """``(causal, hi, windowed, lo, softclamp)`` as the C entry points take them."""
    causal = causal_offset is not None
    windowed = causal and window_lo is not None
    return (int(causal), int(causal_offset) if causal else 0,
            int(windowed), int(window_lo) if windowed else 0,
            float(softclamp_value or 0.0))


def _check_launch(rc: int, name: str, q, k) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )


def _partials_rows(parts: FlashPartials, b, h, nq, d) -> tuple:
    """``_check_kernel_args`` rows of f32 partials for ``(b, h, nq, d)``."""
    return ((parts.acc, (b, h, nq, d), torch.float32),
            (parts.m, (b, h, nq), torch.float32),
            (parts.l, (b, h, nq), torch.float32))


def _seg_ptrs(band) -> tuple:
    """The ``(q_seg, kv_seg, doc_tiles)`` pointers the C entry points take
    (all null: the unsegmented instantiation without a doc-tile table)."""
    return tuple(None if band[key] is None else band[key].data_ptr()
                 for key in ("q_seg", "kv_seg", "doc_tiles"))


def int8_compute(compute_dtype, fn: str = "flash_fwd") -> bool:
    """Whether ``compute_dtype`` asks for the int8 sweep; raises
    ``ValueError`` naming ``fn`` for a value other than None and ``"int8"``,
    as every JAX entry point with the knob does."""
    if compute_dtype not in (None, "int8"):
        raise ValueError(
            f"{fn}: compute_dtype={compute_dtype!r}; supported values are None "
            '(model-dtype matmuls) and "int8" (quantized QK^T/PV)'
        )
    return compute_dtype == "int8"


# ---------------------------------------------------------------------------
# A declared document packing (doc_starts): the TPU kernels' compact tile
# tables (pallas_flash.py :381-470, :578-637), at the CUDA kernels' blocks
# ---------------------------------------------------------------------------

# The blocks of each pass's doc-tile table, by (pass, bf16): the positions
# one block holds (query rows, or keys in the k-major dk/dv pass), the
# positions of one tile of the other side, and whether the blocks are query
# rows.  A packing whose starts are multiples of both aligns with the pass:
# each block and each tile then lies in one document.
DOC_BLOCKS = {
    ("fwd", True): (64, 64, True),  # B1: a warpgroup's 64 rows, 64-key tiles
    ("fwd", False): (64, 64, True),  # B1 f32: a block of 64 rows
    ("dq", True): (64, 64, True),  # B3: a warpgroup's 64 rows
    ("dq", False): (64, 16, True),  # B3 f32: 64 rows, steps of 16 keys
    ("dkv", True): (128, 64, False),  # B2: a block of 128 keys, 64-row tiles
    ("dkv", False): (64, 16, False),  # B2 f32: 64 keys, steps of 16 rows
    # B4 (either output dtype): a warpgroup's 64 rows, 64-key tiles from each
    # quantization block's start (a block of whole tiles keeps them on the
    # table's grid: cuda_flash_q8.q8_packing)
    ("fwd_q8", True): (64, 64, True),
    ("fwd_q8", False): (64, 64, True),
}


def docs_block_aligned(doc_starts, *block_sizes) -> bool:
    """True when every document boundary lands on every block boundary: the
    precondition for dropping cross-document tiles from a pass."""
    return all(s % b == 0 for s in doc_starts for b in block_sizes)


def doc_block_span(doc_starts, pos: int, block: int, n_blocks: int,
                   total: int) -> tuple[int, int]:
    """Inclusive block-index range of the document containing token ``pos``
    (``pallas_flash._doc_block_span``, :406; block-aligned layouts)."""
    d = bisect.bisect_right(doc_starts, pos) - 1
    start = doc_starts[d]
    end = doc_starts[d + 1] if d + 1 < len(doc_starts) else total
    return start // block, min((end - 1) // block, n_blocks - 1)


def band_tile_count(n: int, block: int, tile: int, outer_is_q: bool,
                    causal_offset: int | None = None, window_lo: int | None = None,
                    doc_starts=None) -> int:
    """How many (block, tile) pairs a pass visits, in closed form per block
    (``pallas_flash._band_tile_count``, :425-470, at the CUDA kernels'
    blocks over an ``(n, n)`` span): the band's active range of each outer
    block, intersected with its document's span under an aligned
    ``doc_starts``.  A block with no tile counts 0: the CUDA kernels write
    such a block's output without a dummy tile."""
    n_outer, n_inner = -(-n // block), -(-n // tile)
    hi = causal_offset
    lo = window_lo if hi is not None else None
    count = 0
    for o in range(n_outer):
        first = o * block
        if outer_is_q:
            # active kt: kt*tile <= first+block-1+hi; windowed: kt*tile+tile-1 >= first+lo
            i_hi = n_inner - 1 if hi is None else min((first + block - 1 + hi) // tile,
                                                      n_inner - 1)
            i_lo = max(-(-(first + lo - tile + 1) // tile), 0) if lo is not None else 0
        else:
            # active qt: first <= qt*tile+tile-1+hi; windowed: first+block-1 >= qt*tile+lo
            i_lo = 0 if hi is None else max(-(-(first - hi - tile + 1) // tile), 0)
            i_hi = (min((first + block - 1 - lo) // tile, n_inner - 1) if lo is not None
                    else n_inner - 1)
        if doc_starts is not None:
            d_lo, d_hi = doc_block_span(doc_starts, first, tile, n_inner, n)
            i_lo, i_hi = max(i_lo, d_lo), min(i_hi, d_hi)
        count += max(i_hi - i_lo + 1, 0)
    return count


def doc_tile_ranges(n: int, block: int, tile: int, outer_is_q: bool,
                    causal_offset: int | None = None, window_lo: int | None = None,
                    doc_starts=None) -> np.ndarray:
    """The tiles a pass's kernel visits over an ``(n, n)`` span: ``(ceil(n /
    block), 2)`` int32, row ``o`` the ``[begin, end)`` tiles of ``tile``
    positions of the other side that block ``o`` of ``block`` positions
    meets in the band ``window_lo <= j - i <= causal_offset`` (each bound
    when given) and, with an aligned ``doc_starts``, in its own document.

    The one source of the doc-tile tables: the kernel wrappers launch with
    its rows (the kernel clips its own band range to them, ``doc_clip``)
    and ``masks.certify`` proves them against the mask's oracle."""
    first = np.arange(0, n, block, dtype=np.int64)
    last = np.minimum(first + block, n) - 1
    hi = causal_offset
    lo = window_lo if hi is not None else None
    if outer_is_q:  # rows [first, last] meet keys [lo_pos, hi_pos]
        lo_pos = np.maximum(first + lo, 0) if lo is not None else np.zeros_like(first)
        hi_pos = np.minimum(last + hi, n - 1) if hi is not None else np.full_like(first, n - 1)
    else:  # keys [first, last] meet rows [lo_pos, hi_pos]
        lo_pos = np.maximum(first - hi, 0) if hi is not None else np.zeros_like(first)
        hi_pos = np.minimum(last - lo, n - 1) if lo is not None else np.full_like(first, n - 1)
    begin = lo_pos // tile
    end = np.where(lo_pos <= hi_pos, hi_pos // tile + 1, begin)
    if doc_starts is not None:
        starts = np.asarray(doc_starts, dtype=np.int64)
        doc = np.searchsorted(starts, first, side="right") - 1
        ends = np.append(starts[1:], n)
        begin = np.maximum(begin, starts[doc] // tile)
        end = np.maximum(begin, np.minimum(end, -(-ends[doc] // tile)))
    return np.stack([begin, end], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _doc_table(doc_starts: tuple, pass_: str, bf16: bool, n: int, causal_offset: int,
               window_lo: int | None, device: str) -> torch.Tensor | None:
    """The doc-tile table of one pass on ``device``, or None when the
    layout does not align with the pass's blocks (runtime ids then)."""
    block, tile, outer_is_q = DOC_BLOCKS[(pass_, bf16)]
    if not docs_block_aligned(doc_starts, block, tile):
        return None
    table = doc_tile_ranges(n, block, tile, outer_is_q, causal_offset, window_lo, doc_starts)
    return torch.from_numpy(table).to(device)


def declared_packing(fn: str, pass_: str, doc_starts, q, k, q_seg, kv_seg,
                     causal_offset, window_lo):
    """``(q_seg, kv_seg, doc_tiles)`` of one pass under a declared layout:
    on a CUDA tensor with a causal band and a layout aligned to the pass's
    blocks, its doc-tile table and no ids (the tables carry the whole
    document mask, as the TPU tables do); otherwise the layout as runtime
    ids.  Without a layout, the ids as given."""
    if doc_starts is None:
        return q_seg, kv_seg, None
    if q_seg is not None:
        raise ValueError(
            f"{fn}: doc_starts and document ids both declare the packing; pass one"
        )
    starts = check_doc_starts(doc_starts, q.shape[2], k.shape[2])
    tiles = None
    if q.device.type == "cuda" and causal_offset is not None:
        tiles = _doc_table(starts, pass_, q.dtype == torch.bfloat16, q.shape[2],
                           int(causal_offset),
                           None if window_lo is None else int(window_lo), str(q.device))
    if tiles is not None:
        return None, None, tiles
    ids = doc_runtime_ids(starts, q.shape[2], q.shape[0], q.device)
    return ids, ids, None


def _launch_fwd(q, k, v, kv_mask, band, carry, partials, out=None):
    """Check the inputs and launch the forward kernel in one of its modes:
    ``(out, lse)``, or f32 partials into ``out`` (new tensors when None).
    ``out`` may be ``carry`` itself: each block reads its rows of the carry
    before it writes them."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    rows = ()
    for parts in (carry, out):
        if parts is not None:
            rows += _partials_rows(parts, b, h, nq, d)
    _check_kernel_args("flash_fwd", q, k, v, kv_mask, *rows,
                       segs=(band["q_seg"], band["kv_seg"]))
    from ._build import flash_fwd_library

    lib = flash_fwd_library()
    if partials:
        result = out if out is not None else FlashPartials(
            torch.empty((b, h, nq, d), dtype=torch.float32, device=q.device),
            torch.empty((b, h, nq), dtype=torch.float32, device=q.device),
            torch.empty((b, h, nq), dtype=torch.float32, device=q.device),
        )
        fused_ptrs = (None, None)
        partial_ptrs = tuple(x.data_ptr() for x in result)
    else:
        result = (torch.empty_like(q),
                  torch.empty((b, h, nq), dtype=torch.float32, device=q.device))
        fused_ptrs = tuple(x.data_ptr() for x in result)
        partial_ptrs = (None, None, None)
    carry_ptrs = ((None,) * 3 if carry is None
                  else tuple(x.data_ptr() for x in carry))
    mask_u8 = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(),
            *fused_ptrs, *carry_ptrs, *partial_ptrs,
            b, h, hk, nq, nk, d, int(q.dtype == torch.bfloat16),
            float(band["scale"]),
            *_band_args(band["causal_offset"], band["window_lo"],
                        band["softclamp_value"]),
            *_seg_ptrs(band), ctypes.c_void_p(stream),
        )
    _check_launch(rc, "flash_fwd", q, k)
    global launch_count, seed_launch_count, resume_launch_count
    global fused_carry_launch_count, seg_launch_count, doc_launch_count
    launch_count += 1
    seg_launch_count += band["q_seg"] is not None
    doc_launch_count += band["doc_tiles"] is not None
    if partials and carry is None:
        seed_launch_count += 1
    elif partials:
        resume_launch_count += 1
    elif carry is not None:
        fused_carry_launch_count += 1
    return result


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    carry: FlashPartials | None = None,
    compute_dtype: str | None = None,
    block_k: int | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
    kv_quantized=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward flash sweep: ``(out in q.dtype, lse f32)``, resuming
    ``carry`` when given (a ring's last hop) and leaving it unchanged.

    Same arguments and result as :func:`flash_fwd_reference`.  CPU tensors
    take that plain version; CUDA tensors launch the kernel (its segmented
    instantiation when ids are given; with ``doc_starts``, a declared
    packing instead of ids, the instantiation that drops the tiles of other
    documents where the layout aligns, :func:`declared_packing`).
    ``compute_dtype="int8"`` runs the int8 sweep instead
    (``cuda_flash_q8.flash_fwd_q8``, quantized per block of ``block_k``
    keys, or fed ``kv_quantized``, K/V quantized once before); the float
    sweep does not depend on ``block_k``."""
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value)
    if int8_compute(compute_dtype):
        from .cuda_flash_q8 import flash_fwd_q8

        return flash_fwd_q8(q, k, v, kv_mask, carry=carry, block_k=block_k,
                            kv_quantized=kv_quantized, q_seg=q_seg, kv_seg=kv_seg,
                            doc_starts=doc_starts, **band)
    q_seg, kv_seg, tiles = declared_packing("flash_fwd", "fwd", doc_starts, q, k, q_seg,
                                            kv_seg, causal_offset, window_lo)
    band.update(q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, kv_mask, carry=carry, **band)
    return _launch_fwd(q, k, v, kv_mask, dict(band, doc_tiles=tiles), carry, partials=False)


def flash_partials(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    carry: FlashPartials | None = None,
    out: FlashPartials | None = None,
    compute_dtype: str | None = None,
    block_k: int | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
    kv_quantized=None,
) -> FlashPartials:
    """One forward flash sweep returning f32 partials ``(acc, m, l)``,
    seeded from no carry or resuming ``carry`` (a ring's first and middle
    hops).  The result is written into ``out`` when given, else into new
    tensors; ``out=carry`` resumes in place, which saves an f32 ``(b, h,
    nq, d)`` buffer per hop.  ``carry`` is left unchanged otherwise.

    Same arguments and result as :func:`flash_partials_reference`.  CPU
    tensors take that plain version (copied into ``out``); CUDA tensors
    launch the kernel.  ``compute_dtype``, ``block_k``, the ids,
    ``doc_starts`` and ``kv_quantized`` as in :func:`flash_fwd`."""
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value)
    if int8_compute(compute_dtype):
        from .cuda_flash_q8 import flash_partials_q8

        return flash_partials_q8(q, k, v, kv_mask, carry=carry, out=out, block_k=block_k,
                                 kv_quantized=kv_quantized, q_seg=q_seg, kv_seg=kv_seg,
                                 doc_starts=doc_starts, **band)
    q_seg, kv_seg, tiles = declared_packing("flash_partials", "fwd", doc_starts, q, k,
                                            q_seg, kv_seg, causal_offset, window_lo)
    band.update(q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        result = flash_partials_reference(q, k, v, kv_mask, carry=carry, **band)
        if out is None:
            return result
        for dst, src in zip(out, result):
            dst.copy_(src)
        return out
    return _launch_fwd(q, k, v, kv_mask, dict(band, doc_tiles=tiles), carry, partials=True,
                       out=out)


def _launch_bwd(entry, outs, do, q, k, v, lse, delta, kv_mask, band) -> None:
    """Check the inputs and launch one backward kernel into ``outs``."""
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: no kernel for device {q.device}")
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    _check_kernel_args(
        entry, q, k, v, kv_mask, (do, tuple(q.shape), q.dtype),
        (lse, (b, h, nq), torch.float32), (delta, (b, h, nq), torch.float32),
        segs=(band["q_seg"], band["kv_seg"]),
    )
    from ._build import flash_bwd_library

    lib = flash_bwd_library()
    mask_u8 = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(),
            *(o.data_ptr() for o in outs),
            b, h, hk, nq, nk, d, int(q.dtype == torch.bfloat16),
            float(band["scale"]),
            *_band_args(band["causal_offset"], band["window_lo"],
                        band["softclamp_value"]),
            *_seg_ptrs(band), ctypes.c_void_p(stream),
        )
    _check_launch(rc, entry, q, k)


def flash_bwd_dkv(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv pass: float32 ``(dk, dv)``, each ``(b, hk, nk, d)``.

    Arguments as :func:`flash_bwd_reference`, whose dk and dv a CPU tensor
    takes; a CUDA tensor launches the kernel.  ``do`` has q's dtype.
    ``doc_starts`` as in :func:`flash_fwd`, aligned or not to this pass's
    own blocks."""
    q_seg, kv_seg, tiles = declared_packing("flash_bwd_dkv", "dkv", doc_starts, q, k,
                                            q_seg, kv_seg, causal_offset, window_lo)
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        _, dk, dv = flash_bwd_reference(do, q, k, v, lse, delta, kv_mask, **band)
        return dk, dv
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    _launch_bwd("flash_bwd_dkv", (dk, dv), do, q, k, v, lse, delta, kv_mask,
                dict(band, doc_tiles=tiles))
    global dkv_launch_count, seg_dkv_launch_count, doc_dkv_launch_count
    dkv_launch_count += 1
    seg_dkv_launch_count += q_seg is not None
    doc_dkv_launch_count += tiles is not None
    return dk, dv


def flash_bwd_dq(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """The dq pass: float32 ``dq (b, h, nq, d)``.

    Arguments as :func:`flash_bwd_reference`, whose dq a CPU tensor takes; a
    CUDA tensor launches the kernel.  ``do`` has q's dtype.  ``doc_starts``
    as in :func:`flash_bwd_dkv`."""
    q_seg, kv_seg, tiles = declared_packing("flash_bwd_dq", "dq", doc_starts, q, k,
                                            q_seg, kv_seg, causal_offset, window_lo)
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return flash_bwd_reference(do, q, k, v, lse, delta, kv_mask, **band)[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_bwd("flash_bwd_dq", (dq,), do, q, k, v, lse, delta, kv_mask,
                dict(band, doc_tiles=tiles))
    global dq_launch_count, seg_dq_launch_count, doc_dq_launch_count
    dq_launch_count += 1
    seg_dq_launch_count += q_seg is not None
    doc_dq_launch_count += tiles is not None
    return dq


def flash_bwd(
    do: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    **band,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward passes: float32 ``(dq, dk, dv)``.

    Same arguments and result as :func:`flash_bwd_reference` (and
    ``doc_starts``, per pass as :func:`flash_bwd_dkv` and
    :func:`flash_bwd_dq` take it).  CPU tensors take that plain version;
    CUDA tensors launch the dk/dv kernel, then the dq kernel."""
    if q.device.type == "cpu":
        band = dict(band)
        band["q_seg"], band["kv_seg"], _ = declared_packing(
            "flash_bwd", "dq", band.pop("doc_starts", None), q, k, band.get("q_seg"),
            band.get("kv_seg"), band.get("causal_offset"), band.get("window_lo"))
        return flash_bwd_reference(do, q, k, v, lse, delta, kv_mask, **band)
    dk, dv = flash_bwd_dkv(do, q, k, v, lse, delta, kv_mask, **band)
    return flash_bwd_dq(do, q, k, v, lse, delta, kv_mask, **band), dk, dv


class _CudaFlashAttention(torch.autograd.Function):
    """Port of the ``_pallas_flash_core`` custom_vjp: the forward saves
    ``(q, k, v, kv_mask, q_seg, kv_seg, out, lse)`` (and a declared
    packing's ``doc_starts``, which each pass resolves for its own blocks);
    the backward recomputes p from lse.
    With ``compute_dtype="int8"`` the forward is the int8 sweep and the
    backward the same float kernels, from the exact ``(q, k, v)`` and the
    int8 forward's ``(out, lse)``, as in the JAX package (:2258-2275).
    ``(out, lse)`` are the residuals ``flash_out`` / ``flash_lse`` that a
    ``save_attn`` region keeps (``ops/residuals.py``): its recompute takes
    them back and launches nothing."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_seg, kv_seg, scale, causal_offset,
                window_lo, softclamp_value, compute_dtype, doc_starts=None):
        out, lse = attention_pair(lambda: flash_fwd(
            q, k, v, kv_mask, scale=scale, causal_offset=causal_offset,
            window_lo=window_lo, softclamp_value=softclamp_value,
            compute_dtype=compute_dtype, q_seg=q_seg, kv_seg=kv_seg,
            doc_starts=doc_starts,
        ))
        ctx.save_for_backward(q, k, v, kv_mask, q_seg, kv_seg, out, lse)
        ctx.band = dict(scale=scale, causal_offset=causal_offset,
                        window_lo=window_lo, softclamp_value=softclamp_value,
                        doc_starts=doc_starts)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, q_seg, kv_seg, out, lse = ctx.saved_tensors
        # outside the kernels, as the JAX backward computes it (:2266)
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = flash_bwd(
            do.to(q.dtype).contiguous(), q, k, v, lse, delta, kv_mask,
            q_seg=q_seg, kv_seg=kv_seg, **ctx.band
        )
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None, None)


def cuda_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    window: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    compute_dtype: str | None = None,
    segment_ids=None,
    doc_starts: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Exact flash attention on the CUDA kernels (GQA-aware), differentiable.

    Same contract as ``ops.flash.flash_attention``: ``causal`` is
    end-aligned (``causal_offset = nk - nq``) and drops ``mask``;
    ``window`` keeps the last ``window`` keys of each query;
    ``segment_ids`` (a ``(b, n)`` tensor or a ``(q_ids, kv_ids)`` pair)
    packs documents.  ``doc_starts`` declares a packing instead
    (``pallas_flash_attention(doc_starts=)``): the sorted start offsets of
    the documents of every row, ``nq == nk``; under ``causal`` each pass
    whose blocks the layout aligns drops the tiles of other documents, and
    the others take it as runtime ids.  ``compute_dtype="int8"`` runs the
    forward's QK^T and PV on int8 operands
    (``pallas_flash_attention(compute_dtype="int8")``); the backward stays
    on the float kernels."""
    check_attention_args("cuda_flash_attention", q, k, v, mask)
    q_seg, kv_seg = normalize_segment_ids(segment_ids, q, k, "cuda_flash_attention")
    int8_compute(compute_dtype, "cuda_flash_attention")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and not causal:
        raise ValueError(
            "cuda_flash_attention: lookback windows require causal attention"
        )
    if causal:
        mask = None
    causal_offset = k.shape[2] - q.shape[2] if causal else None
    window_lo = causal_offset - (window - 1) if window is not None else None
    return _CudaFlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), mask, q_seg, kv_seg,
        scale, causal_offset, window_lo, softclamp_value, compute_dtype, doc_starts,
    )


# Keys per stage of csrc/flash_decode.cu (a decode range is a whole number
# of them) and folded query rows per block.
DECODE_TILE = 64
DECODE_ROWS = 16


def decode_split_size(nk: int, splits: int) -> int:
    """Keys per range when ``nk`` keys split into ``splits`` ranges, as the
    decode kernel cuts them: ``ceil(nk / splits)`` rounded up to whole
    tiles, so the last ranges may be short or empty."""
    per = -(-nk // splits)
    return -(-per // DECODE_TILE) * DECODE_TILE


def decode_splits(heads: int, row_groups: int, nk: int, sms: int) -> int:
    """How many ranges the decode kernel splits each kv head's keys into:
    about two blocks (``heads * row_groups`` per range) for each of the
    card's ``sms`` multiprocessors, in one wave (more ranges cost more in
    the merge than they add in parallel reads); at least two tiles a
    range, and no empty range.  Plain integer arithmetic, so that ``nk``
    may also be an integer array (each element's choice)."""
    tiles = -(-nk // DECODE_TILE)
    cap = max(1, 2 * sms // (heads * row_groups))
    want = cap + (tiles // 2 - cap) * (tiles // 2 < cap)  # min(cap, tiles // 2)
    want = want + (1 - want) * (want < 1)  # at least 1
    return -(-nk // decode_split_size(nk, want))


# The decode kernel's workspace, one per (device, stream): an f32 scratch
# for the ranges' partials and int32 counters that each launch leaves at
# zero.  Launches that share one are ordered, as on one stream; reusing it
# spares a decode, which is host-bound at small caches, two allocations.
_DECODE_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _decode_workspace(dev: torch.device, stream: int, n_scratch: int,
                      n_counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    ws = _DECODE_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_scratch or ws[1].numel() < n_counters:
        ws = (torch.empty((max(n_scratch, 1 << 16),), dtype=torch.float32, device=dev),
              torch.zeros((max(n_counters, 1024),), dtype=torch.int32, device=dev))
        _DECODE_WORKSPACE[key] = ws
    return ws


@functools.cache
def _sm_count(index: int | None) -> int:
    """Multiprocessors of CUDA device ``index`` (None: the current one)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_fold(fn, q, k, v, kv_mask):
    """``(b, h, hk, nq, nk, d)`` of a decode, checked."""
    check_attention_args(fn, q, k, v, kv_mask)
    b, h, nq, d = q.shape
    return b, h, k.shape[1], nq, k.shape[2], d


def flash_decode_reference(
    q: torch.Tensor,  # (b, h, nq, d)
    k: torch.Tensor,  # (b, hk, nk, d)
    v: torch.Tensor,  # (b, hk, nk, d)
    kv_mask: torch.Tensor | None = None,  # (b, nk) True = attend
    *,
    scale: float | None = None,
    softclamp_value: float | None = None,
    splits: int = 1,
    fused: bool = True,
):
    """Plain PyTorch version of the decode kernel: the head group folded
    onto query rows, f32 scores ``(q . k) * scale``, softclamp, the key mask
    with the finite ``MASK_VALUE``; each of ``splits`` key ranges
    (:func:`decode_split_size`) gives its own ``(acc, m, l)`` with ``m``
    starting at ``MASK_VALUE``, and the ranges merge in order as the
    kernel's last block merges them.

    Returns, as ``pallas_flash_decode``: ``fused=True`` ``(out (b, h, nq,
    d) in q.dtype, lse (b, h, nq) f32)``; ``fused=False`` f32 partials
    ``(acc (b, hk, g, nq, d), m, l (b, hk, g, nq))``."""
    b, h, hk, nq, nk, d = _decode_fold("flash_decode", q, k, v, kv_mask)
    g = h // hk
    if scale is None:
        scale = d**-0.5
    s = torch.einsum("bhid,bhjd->bhij", q.reshape(b, hk, g * nq, d).float(),
                     k.float()) * scale
    if softclamp_value is not None:
        s = softclamp(s, softclamp_value)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, MASK_VALUE)
    per = decode_split_size(nk, splits)
    m = torch.full(s.shape[:-1], MASK_VALUE, dtype=torch.float32, device=q.device)
    parts = []
    for lo in range(0, splits * per, per):
        span = s[..., min(lo, nk):min(lo + per, nk)]
        m_i = torch.maximum(m, span.amax(dim=-1)) if span.shape[-1] else m
        p = torch.exp(span - m_i[..., None])
        parts.append((m_i, p.sum(dim=-1), torch.einsum(
            "bhij,bhjd->bhid", p, v[:, :, min(lo, nk):min(lo + per, nk)].float())))
    mx = m
    for m_i, _, _ in parts:
        mx = torch.maximum(mx, m_i)
    l = torch.zeros_like(mx)
    acc = torch.zeros((b, hk, g * nq, d), dtype=torch.float32, device=q.device)
    for m_i, l_i, acc_i in parts:
        w = torch.exp(m_i - mx)
        l = l_i * w + l
        acc = acc_i * w[..., None] + acc
    if not fused:
        return (acc.reshape(b, hk, g, nq, d), mx.reshape(b, hk, g, nq),
                l.reshape(b, hk, g, nq))
    out, lse = finalize_partials(FlashPartials(acc, mx, l))
    return out.reshape(b, h, nq, d).to(q.dtype), lse.reshape(b, h, nq)


def cuda_flash_decode(
    q: torch.Tensor,  # (b, h, nq, d), nq tiny (typically 1)
    k: torch.Tensor,  # (b, hk, nk, d)
    v: torch.Tensor,  # (b, hk, nk, d)
    kv_mask: torch.Tensor | None = None,  # (b, nk) True = attend
    *,
    scale: float | None = None,
    softclamp_value: float | None = None,
    fused: bool = True,
    splits: int | None = None,
):
    """Decode attention with the cache read once per kv head.

    The head group folds onto query rows, ``(b, h, nq, d) -> (b, hk,
    g*nq, d)``, and the keys split into ``splits`` ranges (None: the
    wrapper's choice, :func:`decode_splits` on the card, one range on the
    CPU) that the decode kernel sweeps in parallel and merges.  Same
    result as :func:`flash_decode_reference`, which CPU tensors take; CUDA
    tensors launch the kernel."""
    b, h, hk, nq, nk, d = _decode_fold("cuda_flash_decode", q, k, v, kv_mask)
    g = h // hk
    if scale is None:
        scale = d**-0.5
    if splits is not None and splits < 1:
        raise ValueError(f"cuda_flash_decode: splits must be >= 1, got {splits}")
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, kv_mask, scale=scale,
                                      softclamp_value=softclamp_value,
                                      splits=splits or 1, fused=fused)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    rows = g * nq
    folded = q.reshape(b, hk, rows, d).contiguous()
    k, v = k.contiguous(), v.contiguous()
    _check_kernel_args("flash_decode", folded, k, v, kv_mask)
    dev = q.device
    groups = -(-rows // DECODE_ROWS)
    if splits is None:
        splits = decode_splits(b * hk, groups, nk, _sm_count(dev.index))
    from ._build import flash_decode_library

    lib = flash_decode_library()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, counters = _decode_workspace(dev, stream, b * hk * splits * rows * (d + 2),
                                          b * hk * groups)
    if fused:
        result = (torch.empty((b, h, nq, d), dtype=q.dtype, device=dev),
                  torch.empty((b, h, nq), dtype=torch.float32, device=dev))
        ptrs = (result[0].data_ptr(), result[1].data_ptr(), None, None, None)
    else:
        result = (torch.empty((b, hk, g, nq, d), dtype=torch.float32, device=dev),
                  torch.empty((b, hk, g, nq), dtype=torch.float32, device=dev),
                  torch.empty((b, hk, g, nq), dtype=torch.float32, device=dev))
        ptrs = (None, None, *(x.data_ptr() for x in result))
    mask_u8 = None
    if kv_mask is not None:  # a bool tensor is read as its bytes, not copied
        mask_u8 = (kv_mask.contiguous().view(torch.uint8) if kv_mask.dtype == torch.bool
                   else kv_mask.to(torch.uint8).contiguous())
    args = (folded.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(), *ptrs, scratch.data_ptr(),
            counters.data_ptr(), b, hk, rows, nk, d, splits, int(q.dtype == torch.bfloat16),
            float(scale), float(softclamp_value or 0.0), ctypes.c_void_p(stream))
    if dev.index == torch.cuda.current_device():
        rc = lib.flash_decode(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.flash_decode(*args)
    _check_launch(rc, "flash_decode", q, k)
    global decode_launch_count
    decode_launch_count += 1
    return result
