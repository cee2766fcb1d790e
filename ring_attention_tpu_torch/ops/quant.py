"""The int8 codec: symmetric absmax quantization, zero-point free.

Port of ``ring_attention_tpu/ops/quant.py:43-150`` (the package keeps its
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
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


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

