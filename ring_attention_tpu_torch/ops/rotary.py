"""Rotary position embeddings (NeoX-style half rotation).

Port of ``ring_attention_tpu/ops/rotary.py:26-83``.  Positions are
explicit: the single-device model passes ``arange(n)`` (or the decode
position), a ring rank :func:`ring_positions` of its shard, a rank of the
factored hybrid mesh :func:`hybrid_positions`.  Rotary math runs in
float32 and casts back to the input dtype.
"""

from __future__ import annotations

import torch


def ring_positions(n_local: int, rank: int, *, striped: bool, world: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Global token positions ``(n_local,)`` of ring rank ``rank``'s shard:
    ``i * world + rank`` striped, ``i + rank * n_local`` contiguous."""
    i = torch.arange(n_local, device=device)
    if striped:
        return i * world + rank
    return i + rank * n_local


def hybrid_positions(n_local: int, ulysses_rank: int, ring_rank: int, *, ulysses: int,
                     ring: int, striped: bool,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Global token positions ``(n_local,)`` of one shard of a factored
    ``seq = ulysses x ring`` layout (``parallel/hybrid.py``): combined rank
    ``ring_rank * ulysses + ulysses_rank``, ring-major, so local index ``i``
    sits at index ``j = ulysses_rank * n_local + i`` of its ring chunk.
    Striping interleaves at the OUTER ring degree only: ``j * ring +
    ring_rank`` striped, ``ring_rank * ulysses * n_local + j`` contiguous."""
    j = ulysses_rank * n_local + torch.arange(n_local, device=device)
    if striped:
        return j * ring + ring_rank
    return ring_rank * (ulysses * n_local) + j


def rotary_freqs(positions: torch.Tensor, dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Angles ``(n, dim)`` for the positions ``(n,)``."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    return torch.cat([freqs, freqs], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Apply rotary embedding.  ``x: (..., n, d)``, ``freqs: (n, d)``."""
    xf = x.to(torch.float32)
    out = xf * torch.cos(freqs) + rotate_half(xf) * torch.sin(freqs)
    return out.to(x.dtype)
