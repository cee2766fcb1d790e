"""Int8 flash attention on the hand-written CUDA kernels
``csrc/flash_fwd_q8.cu`` and ``csrc/flash_decode_q8.cu``.

Host side of the ports of two modes of ``ring_attention_tpu/ops/
pallas_flash.py``:

- the int8 forward sweep, the ``quantized=True`` mode of
  ``_flash_fwd_call`` (:1174; tile math ``_fwd_tile`` :823 and
  ``_online_update`` :776).  q and k are quantized per row and v per block
  of ``block_k`` keys (``ops/quant.py``, plain PyTorch before the launch, as
  the JAX launcher quantizes in ``jnp`` outside the kernel body,
  :1061-1083); QK^T and PV run on int8 operands; p is quantized per row per
  block of ``block_k`` keys; ``(acc, m, l)`` stay f32.  ``flash_fwd_q8``
  (fused, optionally from a carry) and ``flash_partials_q8`` (partials,
  seeded or resumed, optionally in place) are the kernel wrappers, beside
  their plain versions.  The quantization granularity is part of the
  function: ``block_k`` follows the JAX launch's fitted block
  (:func:`q8_block`), never the CUDA tile.
- the int8 decode, ``pallas_flash_decode_q8`` (:1585, kernel
  ``_decode_q8_kernel`` :1441): a :class:`QuantizedKV` cache with one f32
  scale per ``(head, token)`` row, dequantized in f32 inside the kernel,
  the GQA group folded onto query rows.  ``flash_decode_q8`` is the
  wrapper, ``flash_decode_q8_reference`` its plain version.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version.  ``fwd_launch_count`` (with ``seed_launch_count``,
``resume_launch_count`` and ``fused_carry_launch_count`` for the ring
modes) counts launches of the int8 forward kernel and
``decode_launch_count`` those of the int8 decode; plain-version calls do
not count.  The int8 forward has no backward kernel of its own: as in the
JAX package, the gradient runs the bf16/f32 dk/dv and dq kernels from the
exact ``(q, k, v)`` and the int8 forward's ``(out, lse)``
(``cuda_flash.py::_CudaFlashAttention``).

Three inputs of the JAX launch ride the same sweep:

- ``kv_quantized=`` (the JAX ``kv_quantized=QuantizedBlockKV``, :874,
  :910-912): K/V already quantized, at the launch's fitted block, so that
  only q is quantized per launch.  The kernel reads it in its own operand
  form, :class:`Int8KV` (k per row, V^T per block), which a ring lays out
  once per stream at ring entry (:func:`kernel_kv`; :func:`feed_blob` packs
  it into one int8 tensor that a hop moves whole, :func:`blob_kv` views it
  again).  Its block must equal the launch's :func:`q8_block`, or the call
  raises, as ``pallas_ring.py:259-263`` does;
- ``q_seg``/``kv_seg`` (``q_segment_ids``/``kv_segment_ids``): int32
  document ids; the kernel's segmented instantiation tests them on every
  score of the tiles it visits;
- ``doc_tiles``: a declared packing's doc-tile table
  (``cuda_flash.doc_tile_ranges`` at ``DOC_BLOCKS[("fwd_q8", ...)]``), the
  kDocs instantiation, which clips each warpgroup's visit range to its
  document's tiles and tests no id.  The v block scale still covers every
  key of its block, other documents' keys included, as JAX quantizes
  (``quantize_blocks`` over the whole span): nothing is requantized per
  document.

``seg_launch_count``, ``doc_launch_count`` and ``feed_launch_count`` count
again the launches that took ids, a doc-tile table and a pre-quantized
feed.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .attention import MASK_VALUE, softclamp
from .cuda_flash import (
    SUPPORTED_DTYPES,
    SUPPORTED_HEAD_DIMS,
    _band_args,
    _check_kernel_args,
    _check_launch,
    _decode_workspace,
    _keep,
    _partials_rows,
    _sm_count,
    decode_splits,
)
from .partials import FlashPartials, finalize_partials, init_partials
from .quant import (
    QuantizedBlockKV,
    dequantize_rows,
    quantize_kv_blocks,
    quantize_p,
    quantize_rows,
)

# The JAX launch's default key block (pallas_flash.py DEFAULT_BLOCK_K).
DEFAULT_BLOCK_K = 1024

# Kernel launches since the last reset; the caller may set them to 0.
fwd_launch_count = 0  # flash_fwd_q8, every mode
seed_launch_count = 0  # flash_fwd_q8 writing partials, no carry
resume_launch_count = 0  # flash_fwd_q8 writing partials from a carry
fused_carry_launch_count = 0  # flash_fwd_q8 writing out + lse from a carry
decode_launch_count = 0  # flash_decode_q8
# flash_fwd_q8 launches counted again: with ids, with a doc-tile table, and
# with a pre-quantized K/V feed.
seg_launch_count = 0
doc_launch_count = 0
feed_launch_count = 0


def q8_block(nk: int, block_k: int | None = None) -> int:
    """The quantization block of an int8 sweep over ``nk`` keys: the JAX
    launch's fitted ``block_k`` (``_block_sizes``, pallas_flash.py:153),
    ``min(block_k or 1024, nk)`` halved until it divides ``nk``.  A ring hop
    passes its bucket (``parallel/ring.py:230`` ``_q8_block``)."""
    bk = min(block_k or DEFAULT_BLOCK_K, nk)
    while nk % bk:
        bk //= 2
    return max(bk, 1)


# ---------------------------------------------------------------------------
# The int8 forward: plain version
# ---------------------------------------------------------------------------


def flash_partials_q8_reference(
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
    block_k: int | None = None,
    kv_quantized=None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
) -> FlashPartials:
    """Plain PyTorch version of the int8 kernel's partials modes: the span
    folded into ``carry`` (``init_partials`` when None) one quantization
    block of :func:`q8_block` keys at a time, as the JAX kernel's grid
    steps do.  The integer products run in float64, where they are exact,
    and round once to float32, as the kernel's int32 sums do.  The band,
    key mask and ids are those of ``cuda_flash.flash_partials_reference``;
    every key of the span is visited.  ``kv_quantized`` (an :class:`Int8KV`
    or a ``QuantizedBlockKV``) replaces the quantization of k and v, which
    may then be None."""
    b, h, nq, d = q.shape
    bk, (k8, ks, v8, vs) = _kv_operands("flash_partials_q8", k, v, block_k, kv_quantized,
                                        natural=True)
    hk, nk = k8.shape[1], k8.shape[2]
    g = h // hk
    q8, qs = quantize_rows(q)
    if carry is None:
        carry = init_partials(b, h, nq, d, device=q.device)
    acc = carry.acc.reshape(b, hk, g, nq, d)
    m = carry.m.reshape(b, hk, g, nq)
    l = carry.l.reshape(b, hk, g, nq)
    q8g = q8.reshape(b, hk, g, nq, d).double()
    row_scale = (qs * scale).reshape(b, hk, g, nq, 1)
    keep = _keep(nq, nk, kv_mask, causal_offset, window_lo, q.device, q_seg, kv_seg)
    for j in range(nk // bk):
        cols = slice(j * bk, (j + 1) * bk)
        dot = torch.einsum("bhgid,bhjd->bhgij", q8g, k8[:, :, cols].double()).float()
        s = dot * (row_scale * ks[:, :, None, None, cols])
        if softclamp_value is not None:
            s = softclamp(s, softclamp_value)
        s = torch.where(keep[..., cols], s, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        p8, p_scale = quantize_p(p)
        l = l * alpha + (p8.float() * p_scale).sum(dim=-1)
        pv = torch.einsum("bhgij,bhjd->bhgid", p8.double(), v8[:, :, cols].double())
        acc = acc * alpha[..., None] + pv.float() * (p_scale * vs[:, :, j, None, None, None])
        m = m_new
    return FlashPartials(acc.reshape(b, h, nq, d), m.reshape(b, h, nq),
                         l.reshape(b, h, nq))


def flash_fwd_q8_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the int8 kernel's fused mode: the partials
    of :func:`flash_partials_q8_reference`, normalized.  Returns ``(out in
    q.dtype, lse f32)``."""
    out, lse = finalize_partials(flash_partials_q8_reference(q, k, v, kv_mask, **kw))
    return out.to(q.dtype), lse


# ---------------------------------------------------------------------------
# The int8 forward: kernel wrappers
# ---------------------------------------------------------------------------


# Keys per tile of csrc/flash_fwd_q8.cu: the kernel's V^T pads each
# quantization block to whole tiles.
KEY_TILE = 64


def pv_chunk_keys(device=None) -> torch.Tensor:
    """The key (0..31) behind each contraction index of a 32-key chunk of
    the int8 kernel's P V product: index ``16h + 4t + i`` (h < 2, t < 4,
    i < 4) holds key ``16h + 8 (i // 2) + 2t + i % 2``, the keys that the
    score accumulator leaves thread t of a quad, in the order in which the
    product's register A operand takes them."""
    c = torch.arange(32, device=device)
    h, t, i = c // 16, c % 16 // 4, c % 4
    return 16 * h + 8 * (i // 2) + 2 * t + i % 2


def _tile_keys(block: int, device=None) -> torch.Tensor:
    """The key of a block behind each position of its padded V^T rows
    (``block`` or more: padding)."""
    bp = -(-block // KEY_TILE) * KEY_TILE
    pos = torch.arange(bp, device=device)
    return pos // 32 * 32 + pv_chunk_keys(device)[pos % 32]


def v_block_layout(v8: torch.Tensor, block: int) -> torch.Tensor:
    """``v8 (b, hk, nk, d)`` int8 as the int8 forward kernel reads it: per
    quantization block of ``block`` keys, V^T (a row per column of d, the
    block's keys along it), zero-padded to whole 64-key tiles, each 32-key
    chunk's keys in the order of :func:`pv_chunk_keys`.  Returns ``(b, hk,
    nk // block, d, bp)`` int8, ``bp`` = ``block`` rounded up to 64.  Plain
    PyTorch, on v8's device."""
    b, hk, nk, d = v8.shape
    keys = _tile_keys(block, v8.device)
    blocks = v8.reshape(b, hk, nk // block, block, d)[:, :, :, keys.clamp(max=block - 1)]
    blocks = blocks.masked_fill((keys >= block)[:, None], 0)
    return blocks.transpose(-1, -2).contiguous()


def v_block_natural(v8t: torch.Tensor, block: int) -> torch.Tensor:
    """The inverse of :func:`v_block_layout`: ``(b, hk, nk, d)`` int8."""
    b, hk, n_blk, d, _ = v8t.shape
    keys = _tile_keys(block, v8t.device)
    pos = torch.nonzero(keys < block).flatten()
    inv = torch.empty(block, dtype=torch.long, device=v8t.device)
    inv[keys[pos]] = pos
    return v8t.transpose(-1, -2)[:, :, :, inv].reshape(b, hk, n_blk * block, d)


class Int8KV(NamedTuple):
    """K/V in the int8 forward kernel's operand form: k per row, v per
    block of ``block`` keys as V^T (:func:`v_block_layout`), each tensor
    contiguous and 16-byte aligned.  The kernel's counterpart of a
    ``QuantizedBlockKV``, laid out once (:func:`kernel_kv`)."""

    k8: torch.Tensor  # (b, hk, nk, d) int8
    k_scale: torch.Tensor  # (b, hk, nk) f32
    v8t: torch.Tensor  # (b, hk, nk // block, d, block rounded up to 64) int8
    v_scale: torch.Tensor  # (b, hk, nk // block) f32
    block: int


def kernel_kv(feed: QuantizedBlockKV | Int8KV) -> Int8KV:
    """A ``QuantizedBlockKV`` (the JAX feed, ``quant.payload_kernel_feed``)
    in the kernel's operand form: a layout pass, no quantization."""
    if isinstance(feed, Int8KV):
        return feed
    return Int8KV(feed.k_q.contiguous(), feed.k_scale.contiguous(),
                  v_block_layout(feed.v_q, feed.block), feed.v_scale.contiguous(), feed.block)


def natural_kv(kv: QuantizedBlockKV | Int8KV) -> QuantizedBlockKV:
    """The ``QuantizedBlockKV`` an :class:`Int8KV` holds (v as quantized)."""
    if isinstance(kv, QuantizedBlockKV):
        return kv
    return QuantizedBlockKV(kv.k8, kv.k_scale, v_block_natural(kv.v8t, kv.block), kv.v_scale,
                            kv.block)


def quantize_kv_feed(k: torch.Tensor, v: torch.Tensor, block_k: int | None = None) -> Int8KV:
    """k and v quantized once for every int8 sweep over them: at the fitted
    block of :func:`q8_block` (``block_k`` as the launch takes it), in the
    kernel's form.  One K/V quantization."""
    return kernel_kv(quantize_kv_blocks(k, v, q8_block(k.shape[2], block_k)))


_ALIGN = 16  # bytes: each part of a feed blob starts on a cp.async boundary


def _feed_parts(b: int, hk: int, nk: int, d: int, block: int) -> list:
    """``(offset, shape, dtype)`` of k8, k_scale, v8t, v_scale in a feed
    blob, and its total bytes last."""
    bp = -(-block // KEY_TILE) * KEY_TILE
    parts, offset = [], 0
    for shape, dtype in (((b, hk, nk, d), torch.int8), ((b, hk, nk), torch.float32),
                         ((b, hk, nk // block, d, bp), torch.int8),
                         ((b, hk, nk // block), torch.float32)):
        parts.append((offset, shape, dtype))
        count = 1
        for x in shape:
            count *= x
        offset += -(-count * dtype.itemsize // _ALIGN) * _ALIGN
    return parts + [offset]


def feed_blob(kv: Int8KV) -> torch.Tensor:
    """An :class:`Int8KV` as ONE 1-d int8 tensor (k8, k_scale, v8t, v_scale,
    each at a 16-byte offset): the int8 ring's hop payload, which a
    ``DistributedRing`` moves in one send and the remote tier's slots hold.
    :func:`blob_kv` views it again."""
    b, hk, nk, d = kv.k8.shape
    *parts, total = _feed_parts(b, hk, nk, d, kv.block)
    blob = torch.zeros(total, dtype=torch.int8, device=kv.k8.device)
    for (offset, _, dtype), x in zip(parts, kv[:4]):
        raw = x.contiguous().reshape(-1).view(torch.int8)
        blob[offset:offset + raw.numel()] = raw
    return blob


def blob_kv(blob: torch.Tensor, b: int, hk: int, nk: int, d: int, block: int) -> Int8KV:
    """The :class:`Int8KV` views of a :func:`feed_blob` (no copy)."""
    *parts, total = _feed_parts(b, hk, nk, d, block)
    if blob.dim() != 1 or blob.dtype != torch.int8 or blob.numel() != total:
        raise ValueError(f"blob_kv: expected a 1-d int8 blob of {total} bytes, got "
                         f"{blob.dtype} {tuple(blob.shape)}")
    views = []
    for offset, shape, dtype in parts:
        count = 1
        for x in shape:
            count *= x
        views.append(blob[offset:offset + count * dtype.itemsize].view(dtype).view(shape))
    return Int8KV(*views, block)


def _kv_operands(fn: str, k, v, block_k, kv_quantized, natural: bool):
    """``(block, (k8, k_scale, v8 or v8t, v_scale))``: the feed's, checked
    against the launch's fitted block, or k and v quantized here."""
    if kv_quantized is None:
        bk = q8_block(k.shape[2], block_k)
        feed = quantize_kv_blocks(k, v, bk)
        return bk, tuple(feed[:4]) if natural else tuple(kernel_kv(feed)[:4])
    feed = natural_kv(kv_quantized) if natural else kernel_kv(kv_quantized)
    nk = feed[0].shape[2]
    bk = q8_block(nk, block_k)
    if feed.block != bk:
        raise ValueError(
            f"{fn}: kv feed block {feed.block} != the launch's fitted block {bk} "
            f"(q8_block({nk}, {block_k})); quantize the feed at q8_block"
        )
    return bk, tuple(feed[:4])


class Int8Operands(NamedTuple):
    """q, k, v quantized for the int8 forward kernel: q and k per row, v per
    block of ``block`` keys, in the kernel's V^T layout (:func:`v_block_layout`)."""

    q8: torch.Tensor  # (b, h, nq, d) int8
    q_scale: torch.Tensor  # (b, h, nq) f32
    k8: torch.Tensor  # (b, hk, nk, d) int8
    k_scale: torch.Tensor  # (b, hk, nk) f32
    v8t: torch.Tensor  # (b, hk, nk // block, d, block rounded up to 64) int8
    v_scale: torch.Tensor  # (b, hk, nk // block) f32
    block: int


def quantize_operands(q, k, v, block_k: int | None = None, kv_quantized=None) -> Int8Operands:
    """The wrapper's quantization before the launch (plain PyTorch, on the
    tensors' device): q per row, and k and v unless ``kv_quantized`` holds
    them already."""
    bk, kv = _kv_operands("flash_fwd_q8", k, v, block_k, kv_quantized, natural=False)
    return Int8Operands(*quantize_rows(q), *kv, bk)


def launch_fwd_q8(ops: Int8Operands, kv_mask, band, out_dtype, carry=None,
                  partials=False, out=None, q_seg=None, kv_seg=None, doc_tiles=None,
                  fed=False):
    """Launch the int8 forward kernel on quantized operands: ``(out in
    out_dtype, lse)``, or f32 partials into ``out`` (new tensors when None;
    ``out`` may be ``carry`` itself, each block reading its rows of the
    carry before it writes them).  ``q_seg``/``kv_seg`` run the segmented
    instantiation, ``doc_tiles`` the kDocs one; ``fed`` counts the launch
    as fed a pre-quantized K/V."""
    q8 = ops.q8
    if q8.device.type != "cuda":
        raise ValueError(f"flash_fwd_q8: no kernel for device {q8.device}")
    b, h, nq, d = q8.shape
    _, hk, nk, _ = ops.k8.shape
    if nk % ops.block:
        raise ValueError(f"flash_fwd_q8: block {ops.block} must divide {nk} keys")
    if q_seg is not None and doc_tiles is not None:
        raise ValueError("flash_fwd_q8: ids and a doc-tile table both declare the packing")
    padded = -(-ops.block // KEY_TILE) * KEY_TILE
    rows = ((ops.q_scale, (b, h, nq), torch.float32),
            (ops.k_scale, (b, hk, nk), torch.float32),
            (ops.v8t, (b, hk, nk // ops.block, d, padded), torch.int8),
            (ops.v_scale, (b, hk, nk // ops.block), torch.float32))
    if doc_tiles is not None:
        rows += ((doc_tiles, (-(-nq // KEY_TILE), 2), torch.int32),)
    for parts in (carry, out):
        if parts is not None:
            rows += _partials_rows(parts, b, h, nq, d)
    _check_kernel_args("flash_fwd_q8", q8, ops.k8, ops.v8t, kv_mask, *rows,
                       dtypes=(torch.int8,), segs=(q_seg, kv_seg))
    if out_dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"flash_fwd_q8: output dtype {out_dtype} unsupported")
    from ._build import flash_fwd_q8_library

    lib = flash_fwd_q8_library()
    dev = q8.device
    if partials:
        result = out if out is not None else FlashPartials(
            torch.empty((b, h, nq, d), dtype=torch.float32, device=dev),
            torch.empty((b, h, nq), dtype=torch.float32, device=dev),
            torch.empty((b, h, nq), dtype=torch.float32, device=dev),
        )
        fused_ptrs = (None, None)
        partial_ptrs = tuple(x.data_ptr() for x in result)
    else:
        result = (torch.empty((b, h, nq, d), dtype=out_dtype, device=dev),
                  torch.empty((b, h, nq), dtype=torch.float32, device=dev))
        fused_ptrs = tuple(x.data_ptr() for x in result)
        partial_ptrs = (None, None, None)
    carry_ptrs = ((None,) * 3 if carry is None
                  else tuple(x.data_ptr() for x in carry))
    mask_u8 = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd_q8(
            q8.data_ptr(), ops.k8.data_ptr(), ops.v8t.data_ptr(),
            ops.q_scale.data_ptr(), ops.k_scale.data_ptr(), ops.v_scale.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(),
            *fused_ptrs, *carry_ptrs, *partial_ptrs,
            b, h, hk, nq, nk, d, ops.block, int(out_dtype == torch.bfloat16),
            float(band["scale"]),
            *_band_args(band["causal_offset"], band["window_lo"],
                        band["softclamp_value"]),
            *(None if x is None else x.data_ptr() for x in (q_seg, kv_seg, doc_tiles)),
            ctypes.c_void_p(stream),
        )
    _check_launch(rc, "flash_fwd_q8", q8, ops.k8)
    global fwd_launch_count, seed_launch_count, resume_launch_count
    global fused_carry_launch_count, seg_launch_count, doc_launch_count, feed_launch_count
    fwd_launch_count += 1
    seg_launch_count += q_seg is not None
    doc_launch_count += doc_tiles is not None
    feed_launch_count += bool(fed)
    if partials and carry is None:
        seed_launch_count += 1
    elif partials:
        resume_launch_count += 1
    elif carry is not None:
        fused_carry_launch_count += 1
    return result


def q8_packing(fn: str, doc_starts, q, k, q_seg, kv_seg, causal_offset, window_lo,
               block: int):
    """``(q_seg, kv_seg, doc_tiles)`` of an int8 sweep over keys ``k`` (or
    the feed's k8) under a declared packing (``cuda_flash.declared_packing``
    at ``DOC_BLOCKS[("fwd_q8", ...)]``): the kDocs table only where the
    quantization block is whole 64-key tiles too (each block's tiles then
    start on the table's grid), else runtime ids."""
    from .cuda_flash import declared_packing

    q_seg, kv_seg, tiles = declared_packing(fn, "fwd_q8", doc_starts, q, k, q_seg, kv_seg,
                                            causal_offset, window_lo)
    if tiles is not None and block % KEY_TILE:
        from .attention import doc_runtime_ids

        ids = doc_runtime_ids(tuple(doc_starts), q.shape[2], q.shape[0], q.device)
        return ids, ids, None
    return q_seg, kv_seg, tiles


def _sweep(fn, q, k, v, kv_mask, band, carry, partials, out, block_k, kv_quantized, q_seg,
           kv_seg, doc_starts):
    """The wrappers' one body: the plain version on a CPU tensor, else the
    launch (k and v quantized here unless ``kv_quantized`` holds them)."""
    keys = k if kv_quantized is None else kv_quantized[0]
    tiles = None
    if doc_starts is not None:
        q_seg, kv_seg, tiles = q8_packing(fn, doc_starts, q, keys, q_seg, kv_seg,
                                          band["causal_offset"], band["window_lo"],
                                          q8_block(keys.shape[2], block_k))
    if q.device.type == "cpu":
        kw = dict(carry=carry, block_k=block_k, kv_quantized=kv_quantized, q_seg=q_seg,
                  kv_seg=kv_seg, **band)
        if not partials:
            return flash_fwd_q8_reference(q, k, v, kv_mask, **kw)
        result = flash_partials_q8_reference(q, k, v, kv_mask, **kw)
        if out is None:
            return result
        for dst, src in zip(out, result):
            dst.copy_(src)
        return out
    if kv_quantized is None:
        _check_kernel_args(fn, q, k, v, kv_mask)
    ops = quantize_operands(q, k, v, block_k, kv_quantized)
    return launch_fwd_q8(ops, kv_mask, band, q.dtype, carry=carry, partials=partials, out=out,
                         q_seg=q_seg, kv_seg=kv_seg, doc_tiles=tiles,
                         fed=kv_quantized is not None)


def flash_fwd_q8(
    q: torch.Tensor,
    k: torch.Tensor | None,
    v: torch.Tensor | None,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    carry: FlashPartials | None = None,
    block_k: int | None = None,
    kv_quantized=None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One int8 forward sweep: ``(out in q.dtype, lse f32)``, resuming
    ``carry`` when given and leaving it unchanged.

    Same arguments and result as :func:`flash_fwd_q8_reference`.  CPU
    tensors take that plain version; CUDA tensors are quantized here (q
    only, with ``kv_quantized``: an :class:`Int8KV` or a
    ``QuantizedBlockKV`` at the fitted block) and launch the kernel, its
    segmented instantiation with ids, its kDocs one with a ``doc_starts``
    layout that aligns (:func:`q8_packing`)."""
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value)
    return _sweep("flash_fwd_q8", q, k, v, kv_mask, band, carry, False, None, block_k,
                  kv_quantized, q_seg, kv_seg, doc_starts)


def flash_partials_q8(
    q: torch.Tensor,
    k: torch.Tensor | None,
    v: torch.Tensor | None,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float,
    causal_offset: int | None = None,
    window_lo: int | None = None,
    softclamp_value: float | None = None,
    carry: FlashPartials | None = None,
    out: FlashPartials | None = None,
    block_k: int | None = None,
    kv_quantized=None,
    q_seg: torch.Tensor | None = None,
    kv_seg: torch.Tensor | None = None,
    doc_starts: tuple[int, ...] | None = None,
) -> FlashPartials:
    """One int8 forward sweep returning f32 partials ``(acc, m, l)``,
    seeded or resuming ``carry``; written into ``out`` when given
    (``out=carry`` resumes in place), else into new tensors.

    Same arguments and result as :func:`flash_partials_q8_reference`.  CPU
    tensors take that plain version (copied into ``out``); CUDA tensors as
    in :func:`flash_fwd_q8`."""
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value)
    return _sweep("flash_partials_q8", q, k, v, kv_mask, band, carry, True, out, block_k,
                  kv_quantized, q_seg, kv_seg, doc_starts)


# ---------------------------------------------------------------------------
# The int8 decode cache
# ---------------------------------------------------------------------------


class QuantizedKV(NamedTuple):
    """Int8 KV cache with one f32 scale per ``(head, token)`` row
    (``pallas_flash.py:1405``): 64 + 4 bytes per k or v row at d = 64
    instead of 128 in bf16."""

    k_q: torch.Tensor  # (b, hk, nk, d) int8
    k_scale: torch.Tensor  # (b, hk, nk) f32
    v_q: torch.Tensor  # (b, hk, nk, d) int8
    v_scale: torch.Tensor  # (b, hk, nk) f32


def quantize_kv_cache(k: torch.Tensor, v: torch.Tensor) -> QuantizedKV:
    """Per-token int8 quantization of a KV cache (``ops/quant.py``)."""
    return QuantizedKV(*quantize_rows(k), *quantize_rows(v))


def dequantize_kv_cache(kv: QuantizedKV, dtype: torch.dtype = torch.bfloat16
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(k, v)`` a quantized cache represents: the decode oracle of
    ``impl="torch"`` and of the tests."""
    return (dequantize_rows(kv.k_q, kv.k_scale, dtype),
            dequantize_rows(kv.v_q, kv.v_scale, dtype))


def _decode_layout(fn, q, kv: QuantizedKV, kv_mask):
    b, h, nq, d = q.shape
    if kv.k_q.ndim != 4 or kv.k_q.shape != kv.v_q.shape:
        raise ValueError(f"{fn}: k_q and v_q must share a (b, hk, nk, d) shape")
    _, hk, nk, dk = kv.k_q.shape
    if kv.k_q.shape[0] != b or dk != d or h % hk:
        raise ValueError(
            f"{fn}: q {tuple(q.shape)} does not fit a cache of {tuple(kv.k_q.shape)}"
        )
    for name, s in (("k_scale", kv.k_scale), ("v_scale", kv.v_scale)):
        if tuple(s.shape) != (b, hk, nk):
            raise ValueError(f"{fn}: {name} must be {(b, hk, nk)}, got {tuple(s.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, nk):
        raise ValueError(f"{fn}: kv_mask must be {(b, nk)}, got {tuple(kv_mask.shape)}")
    return b, h, hk, nq, nk, d


def flash_decode_q8_reference(
    q: torch.Tensor,
    kv: QuantizedKV,
    kv_mask: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    softclamp_value: float | None = None,
    fused: bool = True,
):
    """Plain PyTorch version of the int8 decode: k and v dequantized in f32
    (``k8 * k_scale`` per token), f32 scores ``(q . k) * scale``, softclamp,
    the key mask with the finite ``MASK_VALUE``, an f32 softmax.

    Returns, as ``pallas_flash_decode_q8``: ``fused=True`` ``(out (b, h, nq,
    d) in q.dtype, lse (b, h, nq) f32)``; ``fused=False`` f32 partials
    ``(acc (b, hk, g, nq, d), m, l (b, hk, g, nq))``."""
    b, h, hk, nq, nk, d = _decode_layout("flash_decode_q8", q, kv, kv_mask)
    g = h // hk
    if scale is None:
        scale = d**-0.5
    k = kv.k_q.float() * kv.k_scale[..., None]
    v = kv.v_q.float() * kv.v_scale[..., None]
    qf = q.reshape(b, hk, g * nq, d).float()
    s = torch.einsum("bhid,bhjd->bhij", qf, k) * scale
    if softclamp_value is not None:
        s = softclamp(s, softclamp_value)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhij,bhjd->bhid", p, v)
    if not fused:
        return (acc.reshape(b, hk, g, nq, d), m.reshape(b, hk, g, nq),
                l.reshape(b, hk, g, nq))
    out, lse = finalize_partials(FlashPartials(acc, m, l))
    return out.reshape(b, h, nq, d).to(q.dtype), lse.reshape(b, h, nq)


def decode_q8_rows(rows: int) -> int:
    """Folded rows a block of the int8 decode kernel takes (its template
    argument): the power of two at or above ``rows``, at most 16."""
    return min(16, 1 << max(0, rows - 1).bit_length())


def flash_decode_q8(
    q: torch.Tensor,  # (b, h, nq, d), nq tiny (typically 1)
    kv: QuantizedKV,
    kv_mask: torch.Tensor | None = None,  # (b, nk) True = attend
    *,
    scale: float | None = None,
    softclamp_value: float | None = None,
    fused: bool = True,
):
    """Decode attention over an int8 cache, each cache byte read once per
    kv head (the GQA group folds onto query rows), in one launch: the keys
    split into ranges swept in parallel and merged by the last block of a
    kv head to finish, as :func:`cuda_flash.cuda_flash_decode` splits a
    bf16 cache.

    Same arguments and result as :func:`flash_decode_q8_reference`.  CPU
    tensors take that plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_decode_q8_reference(q, kv, kv_mask, scale=scale,
                                         softclamp_value=softclamp_value, fused=fused)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_q8: no kernel for device {q.device}")
    b, h, hk, nq, nk, d = _decode_layout("flash_decode_q8", q, kv, kv_mask)
    g = h // hk
    if scale is None:
        scale = d**-0.5
    if q.dtype not in SUPPORTED_DTYPES or d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash_decode_q8: q must be bf16 or f32 of head dim "
            f"{SUPPORTED_HEAD_DIMS}, got {q.dtype} {tuple(q.shape)}"
        )
    rows = g * nq
    tensors = (q, *kv) + (() if kv_mask is None else (kv_mask,))
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"flash_decode_q8: tensors on {x.device} and {q.device}")
    if kv.k_q.dtype != torch.int8 or kv.v_q.dtype != torch.int8:
        raise ValueError("flash_decode_q8: the cache values must be int8")
    if kv.k_scale.dtype != torch.float32 or kv.v_scale.dtype != torch.float32:
        raise ValueError("flash_decode_q8: the cache scales must be float32")
    q = q.contiguous()
    kv = QuantizedKV(*(x.contiguous() for x in kv))
    if any(x.data_ptr() % 16 for x in (q, *kv)):
        raise ValueError("flash_decode_q8: every input must be 16-byte aligned")
    from ._build import flash_decode_q8_library

    lib = flash_decode_q8_library()
    dev = q.device
    per_block = decode_q8_rows(rows)
    groups = -(-rows // per_block)
    # about four blocks an SM (decode_splits aims at two of the bf16 decode's
    # heavier ones): a range's block is lighter here, and more of them in
    # flight hide the latency of its tiles
    splits = decode_splits(b * hk, groups, nk, 2 * _sm_count(dev.index))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, counters = _decode_workspace(dev, stream, b * hk * splits * rows * (d + 2),
                                          b * hk * groups)
    folded = q.reshape(b, hk, rows, d)
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
    args = (folded.data_ptr(), kv.k_q.data_ptr(), kv.k_scale.data_ptr(),
            kv.v_q.data_ptr(), kv.v_scale.data_ptr(),
            None if mask_u8 is None else mask_u8.data_ptr(), *ptrs, scratch.data_ptr(),
            counters.data_ptr(), b, hk, rows, nk, d, splits, per_block,
            int(q.dtype == torch.bfloat16), float(scale), float(softclamp_value or 0.0),
            ctypes.c_void_p(stream))
    if dev.index == torch.cuda.current_device():
        rc = lib.flash_decode_q8(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.flash_decode_q8(*args)
    _check_launch(rc, "flash_decode_q8", q, kv.k_q)
    global decode_launch_count
    decode_launch_count += 1
    return result

