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
from .quant import dequantize_rows, quantize_blocks, quantize_p, quantize_rows

# The JAX launch's default key block (pallas_flash.py DEFAULT_BLOCK_K).
DEFAULT_BLOCK_K = 1024

# Kernel launches since the last reset; the caller may set them to 0.
fwd_launch_count = 0  # flash_fwd_q8, every mode
seed_launch_count = 0  # flash_fwd_q8 writing partials, no carry
resume_launch_count = 0  # flash_fwd_q8 writing partials from a carry
fused_carry_launch_count = 0  # flash_fwd_q8 writing out + lse from a carry
decode_launch_count = 0  # flash_decode_q8


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
) -> FlashPartials:
    """Plain PyTorch version of the int8 kernel's partials modes: the span
    folded into ``carry`` (``init_partials`` when None) one quantization
    block of :func:`q8_block` keys at a time, as the JAX kernel's grid
    steps do.  The integer products run in float64, where they are exact,
    and round once to float32, as the kernel's int32 sums do.  The band
    and key mask are those of ``cuda_flash.flash_partials_reference``."""
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    g = h // hk
    bk = q8_block(nk, block_k)
    q8, qs = quantize_rows(q)
    k8, ks = quantize_rows(k)
    v8, vs = quantize_blocks(v, bk)
    if carry is None:
        carry = init_partials(b, h, nq, d, device=q.device)
    acc = carry.acc.reshape(b, hk, g, nq, d)
    m = carry.m.reshape(b, hk, g, nq)
    l = carry.l.reshape(b, hk, g, nq)
    q8g = q8.reshape(b, hk, g, nq, d).double()
    row_scale = (qs * scale).reshape(b, hk, g, nq, 1)
    keep = _keep(nq, nk, kv_mask, causal_offset, window_lo, q.device)
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


def v_block_layout(v8: torch.Tensor, block: int) -> torch.Tensor:
    """``v8 (b, hk, nk, d)`` int8 as the int8 forward kernel reads it: per
    quantization block of ``block`` keys, V^T (a row per column of d, the
    block's keys along it), zero-padded to whole 64-key tiles, each 32-key
    chunk's keys in the order of :func:`pv_chunk_keys`.  Returns ``(b, hk,
    nk // block, d, bp)`` int8, ``bp`` = ``block`` rounded up to 64.  Plain
    PyTorch, on v8's device."""
    b, hk, nk, d = v8.shape
    bp = -(-block // KEY_TILE) * KEY_TILE
    pos = torch.arange(bp, device=v8.device)
    keys = pos // 32 * 32 + pv_chunk_keys(v8.device)[pos % 32]
    blocks = v8.reshape(b, hk, nk // block, block, d)[:, :, :, keys.clamp(max=block - 1)]
    blocks = blocks.masked_fill((keys >= block)[:, None], 0)
    return blocks.transpose(-1, -2).contiguous()


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


def quantize_operands(q, k, v, block_k: int | None = None) -> Int8Operands:
    """The wrapper's quantization before the launch (plain PyTorch, on the
    tensors' device)."""
    bk = q8_block(k.shape[2], block_k)
    v8, v_scale = quantize_blocks(v, bk)
    return Int8Operands(*quantize_rows(q), *quantize_rows(k), v_block_layout(v8, bk),
                        v_scale, bk)


def launch_fwd_q8(ops: Int8Operands, kv_mask, band, out_dtype, carry=None,
                  partials=False, out=None):
    """Launch the int8 forward kernel on quantized operands: ``(out in
    out_dtype, lse)``, or f32 partials into ``out`` (new tensors when None;
    ``out`` may be ``carry`` itself, each block reading its rows of the
    carry before it writes them)."""
    q8 = ops.q8
    if q8.device.type != "cuda":
        raise ValueError(f"flash_fwd_q8: no kernel for device {q8.device}")
    b, h, nq, d = q8.shape
    _, hk, nk, _ = ops.k8.shape
    if nk % ops.block:
        raise ValueError(f"flash_fwd_q8: block {ops.block} must divide {nk} keys")
    padded = -(-ops.block // KEY_TILE) * KEY_TILE
    rows = ((ops.q_scale, (b, h, nq), torch.float32),
            (ops.k_scale, (b, hk, nk), torch.float32),
            (ops.v8t, (b, hk, nk // ops.block, d, padded), torch.int8),
            (ops.v_scale, (b, hk, nk // ops.block), torch.float32))
    for parts in (carry, out):
        if parts is not None:
            rows += _partials_rows(parts, b, h, nq, d)
    _check_kernel_args("flash_fwd_q8", q8, ops.k8, ops.v8t, kv_mask, *rows,
                       dtypes=(torch.int8,))
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
            ctypes.c_void_p(stream),
        )
    _check_launch(rc, "flash_fwd_q8", q8, ops.k8)
    global fwd_launch_count, seed_launch_count, resume_launch_count
    global fused_carry_launch_count
    fwd_launch_count += 1
    if partials and carry is None:
        seed_launch_count += 1
    elif partials:
        resume_launch_count += 1
    elif carry is not None:
        fused_carry_launch_count += 1
    return result


def flash_fwd_q8(
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """One int8 forward sweep: ``(out in q.dtype, lse f32)``, resuming
    ``carry`` when given and leaving it unchanged.

    Same arguments and result as :func:`flash_fwd_q8_reference`.  CPU
    tensors take that plain version; CUDA tensors are quantized here and
    launch the kernel."""
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value)
    if q.device.type == "cpu":
        return flash_fwd_q8_reference(q, k, v, kv_mask, carry=carry,
                                      block_k=block_k, **band)
    _check_kernel_args("flash_fwd_q8", q, k, v, kv_mask)
    return launch_fwd_q8(quantize_operands(q, k, v, block_k), kv_mask, band,
                         q.dtype, carry=carry)


def flash_partials_q8(
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
    block_k: int | None = None,
) -> FlashPartials:
    """One int8 forward sweep returning f32 partials ``(acc, m, l)``,
    seeded or resuming ``carry``; written into ``out`` when given
    (``out=carry`` resumes in place), else into new tensors.

    Same arguments and result as :func:`flash_partials_q8_reference`.  CPU
    tensors take that plain version (copied into ``out``); CUDA tensors are
    quantized here and launch the kernel."""
    band = dict(scale=scale, causal_offset=causal_offset, window_lo=window_lo,
                softclamp_value=softclamp_value)
    if q.device.type == "cpu":
        result = flash_partials_q8_reference(q, k, v, kv_mask, carry=carry,
                                             block_k=block_k, **band)
        if out is None:
            return result
        for dst, src in zip(out, result):
            dst.copy_(src)
        return out
    _check_kernel_args("flash_fwd_q8", q, k, v, kv_mask)
    return launch_fwd_q8(quantize_operands(q, k, v, block_k), kv_mask, band,
                         q.dtype, carry=carry, partials=True, out=out)


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

