"""Shape and dtype validation for the public entry points.

Port of ``ring_attention_tpu/utils/validate.py`` with the same messages:
every public attention function checks its argument layout up front and
raises a one-line ``ValueError`` naming the function and the offending
shape, instead of failing deep inside an einsum.
"""

from __future__ import annotations

import torch

_LAYOUT = "(batch, heads, seq, dim_head)"


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def check_attention_args(
    fn: str,
    q,
    k,
    v,
    kv_mask=None,
    *,
    equal_qkv_len: bool = False,
    shards: int = 1,
) -> None:
    """Validate a ``q/k/v (+ kv_mask)`` attention call.

    Layout contract (package-wide): ``q: (b, h, n, d)``,
    ``k, v: (b, hk, n, d)`` with ``h`` a multiple of ``hk`` (GQA),
    ``kv_mask: (b, n_kv)`` boolean.  ``shards > 1`` (a ring entry point
    whose process holds that many ranks) needs both sequences to split
    into that many equal shards.
    """
    for name, x in (("q", q), ("k", k), ("v", v)):
        if getattr(x, "ndim", None) != 4:
            raise ValueError(
                f"{fn}: {name} must be 4-D {_LAYOUT}, got shape {_shape(x)}"
            )
        if not x.dtype.is_floating_point:
            raise ValueError(
                f"{fn}: {name} must be floating point, got dtype {x.dtype}"
            )

    b, h, nq, d = q.shape
    if k.shape != v.shape:
        raise ValueError(
            f"{fn}: k and v must have identical shapes, got k={_shape(k)} "
            f"v={_shape(v)}"
        )
    bk, hk, nk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(
            f"{fn}: q {_shape(q)} and k {_shape(k)} disagree on batch/dim_head "
            f"— expected layout {_LAYOUT}; a (batch, seq, heads, dim) call "
            "usually trips this"
        )
    if hk > h or h % hk:
        raise ValueError(
            f"{fn}: query heads ({h}) must be a positive multiple of kv heads "
            f"({hk}) for GQA, got q={_shape(q)} k={_shape(k)} — expected layout "
            f"{_LAYOUT}; a (batch, seq, heads, dim) call usually trips this"
        )
    if equal_qkv_len and nq != nk:
        raise ValueError(
            f"{fn}: q and k must share the sequence length, got nq={nq} nk={nk}"
        )
    if nq % shards or nk % shards:
        raise ValueError(
            f"{fn}: q ({nq}) and k ({nk}) sequences must split into {shards} "
            f"equal shards, one per ring rank this process holds"
        )
    if kv_mask is not None:
        if getattr(kv_mask, "ndim", None) != 2 or tuple(kv_mask.shape) != (b, nk):
            raise ValueError(
                f"{fn}: kv_mask must be (batch, n_kv) = ({b}, {nk}), got "
                f"shape {_shape(kv_mask)}"
            )


def check_segment_ids(fn: str, q, k, q_seg, kv_seg) -> None:
    """Validate packed-sequence segment ids against a q/k pair.

    Contract: ``q_seg: (b, nq)`` and ``kv_seg: (b, nk)`` integer document
    ids (real ids >= 0; -1 marks padding)."""
    b, _, nq, _ = q.shape
    nk = k.shape[2]
    for name, seg, n in (("q", q_seg, nq), ("kv", kv_seg, nk)):
        if getattr(seg, "ndim", None) != 2 or tuple(seg.shape) != (b, n):
            raise ValueError(
                f"{fn}: {name} segment_ids must be (batch, n) = ({b}, {n}), "
                f"got shape {_shape(seg)} — a single (b, n) array needs "
                f"nq == nk; pass a (q_ids, kv_ids) pair otherwise"
            )
        if not _is_integer(seg.dtype):
            raise ValueError(
                f"{fn}: {name} segment_ids must be integers, got {seg.dtype}"
            )


def check_model_input(fn: str, x, dim: int) -> None:
    """Validate a module call ``x: (b, n, dim)``."""
    if getattr(x, "ndim", None) != 3 or x.shape[-1] != dim:
        raise ValueError(
            f"{fn}: x must be (batch, seq, dim={dim}), got shape {_shape(x)}"
        )


def check_tokens_input(fn: str, x) -> None:
    """Validate a transformer call ``tokens: (b, n)`` integer ids."""
    if getattr(x, "ndim", None) != 2:
        raise ValueError(
            f"{fn}: tokens must be (batch, seq) integer ids, got shape {_shape(x)}"
        )
    if not _is_integer(x.dtype):
        raise ValueError(
            f"{fn}: tokens must be integer ids, got dtype {x.dtype}"
        )
