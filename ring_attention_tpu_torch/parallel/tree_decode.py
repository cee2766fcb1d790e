"""Tree-attention decoding over a KV cache sharded on the ring.

Port of ``ring_attention_tpu/parallel/tree_decode.py:31-144``.  At decode
time the query is a token or a few (the same on every rank) while the KV
cache is sharded over the ring's ranks: each rank computes the
online-softmax partials ``(acc, m, l)`` of its own shard, and the partials
merge with three collectives over the ring (``Ring.all_reduce``): MAX over
``m``, SUM over the rescaled ``acc`` and ``l``, then ``num / max(den,
EPSILON)``.

A rank whose shard holds no valid key (a padded cache, a prompt shorter
than the first shards) keeps ``m`` at the finite ``MASK_VALUE`` with ``l >
0``; its weight vanishes in the merge through ``exp(m - m_global)``.

The local partial of a held rank runs on:

- ``impl="cuda"``: the split-KV decode kernel in partials mode
  (``ops/cuda_flash.py::cuda_flash_decode(fused=False)``, B5), one launch
  per held rank's shard;
- an int8 cache (``kv_quantized``): the int8 decode kernel in partials mode
  (``ops/cuda_flash_q8.py::flash_decode_q8(fused=False)``, B6), unless
  ``impl="torch"``, which dequantizes the shard and runs the PyTorch sweep;
- ``impl="torch"``: the blockwise PyTorch sweep (``ops/flash.py``).

The cache comes as one tensor per held rank's shard, which the kernels
read in place: a decode step copies no cache byte.  On CPU tensors the
kernel wrappers run their plain versions.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from ..ops.attention import EPSILON
from ..ops.cuda_flash import cuda_flash_decode
from ..ops.cuda_flash_q8 import QuantizedKV, dequantize_kv_cache, flash_decode_q8
from ..ops.flash import _ungroup, attend_blocks, init_carry
from ..utils.validate import check_attention_args
from .collectives import Ring

IMPLS = ("torch", "cuda")


def _check_quantized(q, kv: QuantizedKV, kv_mask) -> None:
    """The layout contract of ``check_attention_args`` for an int8 shard."""
    kq = kv.k_q
    if q.ndim != 4 or kq.ndim != 4:
        raise ValueError(
            "tree_attn_decode: q and kv_quantized.k_q must be (batch, heads, "
            "seq, dim) - a (batch, seq, heads, dim) call usually trips this "
            f"(got q {tuple(q.shape)}, k_q {tuple(kq.shape)})"
        )
    if q.shape[0] != kq.shape[0] or q.shape[3] != kq.shape[3] or q.shape[1] % kq.shape[1]:
        raise ValueError(
            f"tree_attn_decode: q {tuple(q.shape)} incompatible with int8 cache "
            f"{tuple(kq.shape)} (batch/dim must match, heads must be a multiple "
            f"of kv heads)"
        )
    if kv_mask is not None and tuple(kv_mask.shape) != (kq.shape[0], kq.shape[2]):
        raise ValueError(
            f"tree_attn_decode: kv_mask must be (batch, seq) = "
            f"{(kq.shape[0], kq.shape[2])}, got {tuple(kv_mask.shape)}"
        )


def _per_rank(name: str, shards, count: int) -> list:
    """``shards`` as a list of one entry per held rank (None: ``count``
    Nones)."""
    if shards is None:
        return [None] * count
    shards = list(shards)
    if len(shards) != count:
        raise ValueError(
            f"tree_attn_decode: {len(shards)} {name} shards for the {count} "
            f"ring ranks this process holds"
        )
    return shards


def tree_attn_decode(
    q: torch.Tensor,
    k: Sequence[torch.Tensor] | None,
    v: Sequence[torch.Tensor] | None,
    kv_mask: Sequence[torch.Tensor] | None = None,
    *,
    ring: Ring,
    bucket_size: int | None = None,
    softclamp_value: float | None = None,
    scale: float | None = None,
    impl: str | None = None,
    kv_quantized: Sequence[QuantizedKV] | None = None,
) -> torch.Tensor:
    """Decode attention of ``q`` against a KV cache sharded over ``ring``.

    Args:
      q: ``(b, h, nq, d)`` queries, the same for every rank (``nq`` is
        typically 1).
      k, v: the cache shards of the ranks this process holds
        (``ring.ranks``), one ``(b, hk, n_local, d)`` tensor per rank in
        rank order: every rank's on a ``VirtualRing``, rank ``r`` owning the cache's
        slots ``[r * n_local, (r + 1) * n_local)``; the local one on a
        ``DistributedRing``.  The kernels read each shard in place, so a
        shard on the card must be contiguous.  GQA when ``hk < h``.
      kv_mask: optional ``(b, n_local)`` masks of each shard's valid slots
        (True = attend), one per held rank.
      bucket_size: the key tile of the ``impl="torch"`` sweep (None: the
        whole shard at once); the kernels' tiles are fixed.
      impl: ``"cuda"`` (B5 partials), ``"torch"`` (the PyTorch sweep), or
        None: ``"torch"`` for a plain cache, B6 for an int8 one.
      kv_quantized: the int8 cache shards (``quantize_kv_cache``), one
        ``QuantizedKV`` per held rank, in place of ``k`` and ``v``, which
        must then be None; their partials come from B6 unless
        ``impl="torch"``, which dequantizes them.

    Returns ``(b, h, nq, d)`` in ``q.dtype``, the same on every rank.
    """
    if impl not in (None, *IMPLS):
        raise ValueError(f"tree_attn_decode: unknown impl {impl!r}")
    b, h, nq, d = q.shape
    if scale is None:
        scale = d**-0.5
    count = len(ring.ranks)
    masks = _per_rank("kv_mask", kv_mask, count)
    if kv_quantized is not None:
        if k is not None or v is not None:
            raise ValueError("tree_attn_decode: pass either k/v or kv_quantized, not both")
        kv_quantized = _per_rank("kv_quantized", kv_quantized, count)
        for kv_j, mask_j in zip(kv_quantized, masks):
            _check_quantized(q, kv_j, mask_j)
        if impl == "torch":
            # honor the explicit request: dequantize and run the sweep
            k, v = zip(*(dequantize_kv_cache(kv_j, q.dtype) for kv_j in kv_quantized))
            kv_quantized = None
    parts = []
    if kv_quantized is not None:
        for kv_j, mask_j in zip(kv_quantized, masks):
            parts.append(flash_decode_q8(q, kv_j, mask_j, scale=scale,
                                         softclamp_value=softclamp_value, fused=False))
    else:
        for k_j, v_j, mask_j in zip(_per_rank("k", k, count), _per_rank("v", v, count),
                                    masks):
            check_attention_args("tree_attn_decode", q, k_j, v_j, mask_j)
            if impl == "cuda":
                parts.append(cuda_flash_decode(
                    q, k_j, v_j, mask_j, scale=scale, softclamp_value=softclamp_value,
                    fused=False,
                ))
            else:
                hk = k_j.shape[1]
                carry = init_carry(b, hk, h // hk, nq, d, device=q.device)
                parts.append(tuple(attend_blocks(
                    q, k_j, v_j, carry, scale=scale, bucket_size=bucket_size,
                    kv_mask=mask_j, softclamp_value=softclamp_value,
                )))
    # the three-collective merge: MAX over m, SUM over the rescaled acc, l
    m_global = ring.all_reduce([(m,) for _, m, _ in parts], "max")
    rescaled = []
    for (acc, m, l), (m_max,) in zip(parts, m_global):
        correction = torch.exp(m - m_max)
        rescaled.append((acc * correction[..., None], l * correction))
    num, den = ring.all_reduce(rescaled, "sum")[0]
    out = num / torch.clamp(den, min=EPSILON)[..., None]
    return _ungroup(out).to(q.dtype)
