"""Dense attention oracle in plain PyTorch.

Port of ``ring_attention_tpu/ops/attention.py``: exact, score-materializing
attention used as the ground truth of the port's tests and as the decode
attention of the ``impl="torch"`` path.

Layout at every public function: ``q: (b, h, n, d)``, ``k, v: (b, hk, n, d)``
(heads-major, as in the JAX package).  Query head ``j`` reads kv head
``j // (h // hk)``.
"""

from __future__ import annotations

import torch

from ..utils.validate import check_attention_args

# Large-but-finite mask value: -inf would make a fully masked row NaN
# (exp(-inf - -inf)); with a finite value such a row averages V uniformly.
MASK_VALUE = -0.5 * float(torch.finfo(torch.float32).max)
EPSILON = 1e-10

# Segment id reserved for padding (packed sequences arrive with the
# mask-algebra slice; the constant is shared already).
PAD_SEGMENT_ID = -1


def softclamp(x: torch.Tensor, value: float) -> torch.Tensor:
    """Soft clamp logits to (-value, value) via tanh (Gemma-style capping)."""
    return torch.tanh(x / value) * value


def default_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    softclamp_value: float | None = None,
) -> torch.Tensor:
    """Exact dense attention.

    Args:
      q: ``(b, h, nq, d)`` queries.
      k: ``(b, hk, nk, d)`` keys; ``h`` must be a multiple of ``hk`` (GQA).
      v: ``(b, hk, nk, d)`` values.
      mask: optional ``(b, nk)`` boolean key-padding mask, True = attend.
      causal: end-aligned causal mask (query ``i`` sees keys
        ``j <= i + nk - nq``); ``mask`` is ignored when set.
      softclamp_value: if set, logits are soft-clamped to this magnitude.

    Returns:
      ``(b, h, nq, d)`` attention output in ``q.dtype``.
    """
    check_attention_args("default_attention", q, k, v, mask)
    b, h, nq, d = q.shape
    _, hk, nk, _ = k.shape
    g = h // hk

    scale = d**-0.5
    qg = q.reshape(b, hk, g, nq, d).float()
    sim = torch.einsum("bhgid,bhjd->bhgij", qg, k.float()) * scale

    if softclamp_value is not None:
        sim = softclamp(sim, softclamp_value)

    if causal:
        i = torch.arange(nq, device=q.device)[:, None]
        j = torch.arange(nk, device=q.device)[None, :]
        sim = torch.where(j <= i + (nk - nq), sim, MASK_VALUE)
    elif mask is not None:
        sim = torch.where(mask[:, None, None, None, :], sim, MASK_VALUE)

    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhgij,bhjd->bhgid", attn, v.float())
    return out.reshape(b, h, nq, d).to(q.dtype)
