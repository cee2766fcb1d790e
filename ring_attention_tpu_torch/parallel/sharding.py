"""Sequence layout transforms: padding, striping and the zig-zag layout.

Port of ``ring_attention_tpu/parallel/sharding.py:23-148``.  Striping
(Striped Attention, arXiv 2311.09431) gives ring rank ``r`` of ``W`` the
tokens ``{i * W + r}``, so every hop of a causal ring has equal work; at
token granularity, as the JAX package stripes.  The zig-zag layout
(``parallel/zigzag.py``) gives rank ``r`` the chunks ``(r, 2W-1-r)`` of
``2W``.  The layouts are pure index permutations of a global ``(batch,
seq, ...)`` tensor; sharding the result contiguously over the ring gives
each rank its tokens.

The schemes ``"contiguous"``, ``"striped"`` and ``"zigzag"`` are ported;
Ulysses and the hybrid factoring raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .zigzag import zigzag_permute, zigzag_unpermute

UNPORTED_SCHEMES = {
    "ulysses": "the Ulysses strategy, ROADMAP.md Port queue item 7",
    "hybrid": "the hybrid Ulysses x Ring strategy, ROADMAP.md Port queue item 7",
}


def _unported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f'sequence_parallel="{name}" is not ported yet; it arrives with '
        f"{UNPORTED_SCHEMES[name]}"
    )


def pad_to_multiple(
    x: torch.Tensor, multiple: int, axis: int = 1, value: float = 0.0
) -> tuple[torch.Tensor, int]:
    """Pad ``axis`` up to a multiple; returns ``(padded, original_length)``."""
    n = x.shape[axis]
    rem = n % multiple
    if rem == 0:
        return x, n
    pad = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, multiple - rem]
    return F.pad(x, pad, value=value), n


def pad_seq_and_mask(
    x: torch.Tensor, mask: torch.Tensor | None, multiple: int
) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """Pad tokens and key-padding mask together; when padding is added and
    no mask exists, one is made so padded positions never receive
    attention."""
    x_padded, n = pad_to_multiple(x, multiple)
    if x_padded.shape[1] == n and mask is None:
        return x_padded, None, n
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    mask_padded, _ = pad_to_multiple(mask, multiple, axis=1, value=False)
    return x_padded, mask_padded, n


def _check_divides(fn: str, n: int, ring_size: int) -> None:
    if n % ring_size:
        raise ValueError(f"{fn}: sequence {n} does not divide over {ring_size} ranks")


def stripe_permute(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """``[x0, x1, ..., x_{n-1}] -> [x0, x_W, x_2W, ..., x1, x_{1+W}, ...]``:
    sharding the result contiguously over ``W`` ranks gives rank ``r`` the
    tokens ``≡ r (mod W)``."""
    n = x.shape[axis]
    _check_divides("stripe_permute", n, ring_size)
    shape = list(x.shape)
    x = x.reshape(shape[:axis] + [n // ring_size, ring_size] + shape[axis + 1:])
    return x.transpose(axis, axis + 1).reshape(shape)


def stripe_unpermute(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`stripe_permute`."""
    n = x.shape[axis]
    _check_divides("stripe_unpermute", n, ring_size)
    shape = list(x.shape)
    x = x.reshape(shape[:axis] + [ring_size, n // ring_size] + shape[axis + 1:])
    return x.transpose(axis, axis + 1).reshape(shape)


def layout_for(sequence_parallel: str, striped: bool, seq_world: int) -> tuple[str, int]:
    """``(scheme, factor)`` of the model-top sequence permutation: the one
    derivation the attention layer and the transformer both consult."""
    if sequence_parallel in UNPORTED_SCHEMES:
        raise _unported(sequence_parallel)
    if sequence_parallel not in ("ring", "zigzag"):
        raise ValueError(f"unknown sequence_parallel {sequence_parallel!r}")
    if seq_world <= 1:
        return "contiguous", 1
    if sequence_parallel == "zigzag":
        return "zigzag", seq_world
    return ("striped" if striped else "contiguous"), seq_world


def layout_permute(x: torch.Tensor, scheme: str, factor: int) -> torch.Tensor:
    """Apply the sequence-layout permutation one scheme needs (axis 1)."""
    if scheme == "contiguous":
        return x
    if scheme == "striped":
        return stripe_permute(x, factor)
    if scheme == "zigzag":
        return zigzag_permute(x, factor)
    if scheme in UNPORTED_SCHEMES:
        raise _unported(scheme)
    raise ValueError(f"unknown sequence layout scheme {scheme!r}")


def layout_unpermute(x: torch.Tensor, scheme: str, factor: int) -> torch.Tensor:
    """Inverse of :func:`layout_permute`."""
    if scheme == "contiguous":
        return x
    if scheme == "striped":
        return stripe_unpermute(x, factor)
    if scheme == "zigzag":
        return zigzag_unpermute(x, factor)
    if scheme in UNPORTED_SCHEMES:
        raise _unported(scheme)
    raise ValueError(f"unknown sequence layout scheme {scheme!r}")
