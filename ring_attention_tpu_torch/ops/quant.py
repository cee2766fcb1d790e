"""The int8 codec: symmetric absmax quantization, zero-point free.

Port of ``ring_attention_tpu/ops/quant.py:43-216`` (the package keeps its
own copy; it imports nothing of the JAX package).  One full-scale constant,
``INT8_MAX = 127``, and two granularities:

- per row (:func:`quantize_rows`): one f32 scale per trailing-axis row, the
  ``(head, token)`` granularity of the decode cache and of q and k in the
  int8 forward (the scale rides a free index of the matmul);
- per block (:func:`quantize_blocks`): one f32 scale per ``(block, d)``
  token slab, the granularity of v in the int8 forward (PV contracts over
  tokens, so only a per-block scalar pulls out of the product).

Subtleties kept as in the JAX package: :func:`quantize_rows` and
:func:`quantize_blocks` return the *unsafe* scale (0 for an all-zero row),
:func:`quantize_p` the *safe* one (1 for an all-zero row); ``torch.round``
rounds half to even, as ``jnp.round`` does.

The ring's int8 wire (``hop_compression="int8"``, ``:121-216``): K/V
quantized once at ring entry into ONE int8 payload ``(2, b, hk, n, d + 4)``
per hop (:func:`pack_kv`: k at index 0, v at 1, channels ``[0:d]`` the
values and ``[d:d + 4]`` the row's f32 scale as its four little-endian
bytes, byte for byte the JAX payload), :func:`unpack_kv` its values, and
:func:`payload_kernel_feed` the int8 forward's K/V operands read straight
off its bytes (:class:`QuantizedBlockKV`: k per row, v per block).
``kv_quantize_count`` counts the K/V quantizations (:func:`quantize_kv_blocks`
and :func:`pack_kv`) since the last reset: a ring quantizes once per
stream, not once per hop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT8_MAX = 127.0
# Bytes of one f32 scale riding a payload row.
SCALE_BYTES = 4

# K/V quantizations since the last reset; the caller may set it to 0.
kv_quantize_count = 0


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 over the last axis: ``(values int8 like x,
    scales f32 of x.shape[:-1])`` with ``x ≈ values * scales[..., None]``.
    An all-zero row gets scale 0 and zero values."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / INT8_MAX
    safe = torch.where(scale > 0, scale, 1.0)
    xq = torch.round(xf / safe[..., None])
    return xq.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_rows(values: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """What a :func:`quantize_rows` pair represents, in ``dtype``."""
    return (values.float() * scales[..., None]).to(dtype)


def quantize_blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax over ``(block, d)`` token slabs of ``x (..., n, d)``;
    ``block`` divides ``n``.  Returns ``(values int8 like x, scales f32 of
    x.shape[:-2] + (n // block,))``."""
    n, d = x.shape[-2], x.shape[-1]
    if n % block:
        raise ValueError(f"quantize_blocks: block {block} must divide the token axis {n}")
    xb = x.float().reshape(*x.shape[:-2], n // block, block, d)
    scale = xb.abs().amax(dim=(-2, -1)) / INT8_MAX
    safe = torch.where(scale > 0, scale, 1.0)
    xq = torch.round(xb / safe[..., None, None]).clamp(-INT8_MAX, INT8_MAX)
    return xq.to(torch.int8).reshape(x.shape), scale


def dequantize_blocks(values: torch.Tensor, scales: torch.Tensor, block: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """What a :func:`quantize_blocks` pair represents, in ``dtype``."""
    n, d = values.shape[-2], values.shape[-1]
    vb = values.float().reshape(*values.shape[:-2], n // block, block, d)
    return (vb * scales[..., None, None]).reshape(values.shape).to(dtype)


def quantize_p(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An online-softmax probability tile ``p >= 0`` to int8, per row:
    ``(p8 int8, safe scale (..., 1) f32)``, the scale ``rowmax / 127`` or 1
    for an all-zero row."""
    scale = p.amax(dim=-1, keepdim=True) / INT8_MAX
    safe = torch.where(scale > 0, scale, 1.0)
    return torch.round(p / safe).to(torch.int8), safe



class QuantizedBlockKV(NamedTuple):
    """K/V quantized for the int8 forward: k per row, ``(b, hk, n)`` f32
    scales (the key axis is a free index of QK^T), v per block of ``block``
    keys, ``(b, hk, n // block)`` (PV contracts over keys, so only a
    per-block scalar pulls out).  ``block`` must equal the launch's fitted
    block (``cuda_flash_q8.q8_block``)."""

    k_q: torch.Tensor  # (b, hk, n, d) int8
    k_scale: torch.Tensor  # (b, hk, n) f32
    v_q: torch.Tensor  # (b, hk, n, d) int8
    v_scale: torch.Tensor  # (b, hk, n // block) f32
    block: int


def quantize_kv_blocks(k: torch.Tensor, v: torch.Tensor, block: int) -> QuantizedBlockKV:
    """Quantize a K/V pair for the int8 forward (k per row, v per block of
    ``block`` keys); one K/V quantization."""
    global kv_quantize_count
    kv_quantize_count += 1
    return QuantizedBlockKV(*quantize_rows(k), *quantize_blocks(v, block), block)


def pack_kv(k: torch.Tensor, v: torch.Tensor, *, v_block: int | None = None) -> torch.Tensor:
    """Pack a K/V pair into ONE int8 ring-hop payload ``(2, b, hk, n, d +
    4)``: k at index 0, v at 1, channels ``[0:d]`` the values and ``[d:d +
    4]`` each row's f32 scale as its four bytes.  ``v_block=None``
    quantizes v per row; ``v_block=B`` per ``(B, d)`` slab, each block's
    scale repeated on its rows, so that :func:`payload_kernel_feed` reads
    the int8 forward's operands off the bytes.  One K/V quantization."""
    global kv_quantize_count
    kv_quantize_count += 1
    k_q, k_s = quantize_rows(k)
    if v_block is None:
        v_q, v_s = quantize_rows(v)
    else:
        v_q, v_s = quantize_blocks(v, v_block)
        v_s = v_s.repeat_interleave(v_block, dim=-1)
    vals = torch.stack([k_q, v_q])
    scale_bytes = torch.stack([k_s, v_s]).contiguous().view(torch.int8)  # (..., n * 4)
    scale_bytes = scale_bytes.reshape(*vals.shape[:-1], SCALE_BYTES)
    return torch.cat([vals, scale_bytes], dim=-1)


def _payload_scales(payload: torch.Tensor) -> torch.Tensor:
    """The ``(2, b, hk, n)`` f32 scales of a payload, from their bytes."""
    d = payload.shape[-1] - SCALE_BYTES
    return payload[..., d:].contiguous().view(torch.float32)[..., 0]


def unpack_kv(payload: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(k, v)`` a payload represents, in ``dtype`` (row- and
    block-quantized payloads alike: block scales ride on every row)."""
    d = payload.shape[-1] - SCALE_BYTES
    kv = payload[..., :d].float() * _payload_scales(payload)[..., None]
    return kv[0].to(dtype), kv[1].to(dtype)


def payload_kernel_feed(payload: torch.Tensor, v_block: int) -> QuantizedBlockKV | None:
    """The int8 forward's K/V operands of a ``pack_kv(v_block=...)``
    payload, with no dequantize: the values, k's row scales, and v's block
    scales sampled every ``v_block``-th row (block-constant by
    construction).  None when ``v_block`` does not divide the keys."""
    d = payload.shape[-1] - SCALE_BYTES
    if payload.shape[-2] % v_block:
        return None
    vals = payload[..., :d]
    scales = _payload_scales(payload)
    return QuantizedBlockKV(vals[0], scales[0], vals[1],
                            scales[1][..., ::v_block].contiguous(), v_block)
