"""Raw online-softmax partials in the kernels' flat layout.

Port of ``ring_attention_tpu/ops/pallas_flash.py`` ``FlashPartials``
(:861), ``init_partials`` (:1610), ``merge_partials`` (:1625) and
``finalize_partials`` (:1637).  A ring hop's forward sweep emits
``(acc, m, l)`` in float32 with ``m`` in natural units, ``out = acc / l``
and ``lse = m + log l``; the CUDA kernel resumes such a carry in-kernel and
the plain versions fold a span into one with dense scores.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .attention import EPSILON, MASK_VALUE


class FlashPartials(NamedTuple):
    """Raw online-softmax partials: out = acc / l, lse = m + log l."""

    acc: torch.Tensor  # (b, h, nq, d) f32
    m: torch.Tensor  # (b, h, nq) f32
    l: torch.Tensor  # (b, h, nq) f32


def init_partials(
    b: int, h: int, nq: int, d: int, device: torch.device | str = "cpu"
) -> FlashPartials:
    """Identity element for :func:`merge_partials`: a row that has seen no
    key (``m`` at the finite ``MASK_VALUE``, nothing summed)."""
    return FlashPartials(
        torch.zeros((b, h, nq, d), dtype=torch.float32, device=device),
        torch.full((b, h, nq), MASK_VALUE, dtype=torch.float32, device=device),
        torch.zeros((b, h, nq), dtype=torch.float32, device=device),
    )


def merge_partials(a: FlashPartials, b: FlashPartials) -> FlashPartials:
    """Exact online-softmax merge of two partial sweeps (associative)."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    return FlashPartials(
        a.acc * ea[..., None] + b.acc * eb[..., None],
        m,
        a.l * ea + b.l * eb,
    )


def finalize_partials(p: FlashPartials) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out f32 (b, h, n, d), lse (b, h, n))``."""
    l_safe = torch.clamp(p.l, min=EPSILON)
    return p.acc / l_safe[..., None], p.m + torch.log(l_safe)
