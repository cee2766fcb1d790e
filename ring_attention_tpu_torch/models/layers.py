"""Transformer building blocks: Dense, Embed, RMSNorm and FeedForward.

Ports of ``ring_attention_tpu/models/layers.py:34-83`` and of the flax
``nn.Dense``/``nn.Embed`` semantics the JAX model relies on: parameters are
kept in float32 and cast to the module's compute ``dtype`` at use (with
``dtype=None`` the computation runs in the promoted input/parameter type,
float32 here).  Norm statistics are float32 whatever the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device a module is built on: CUDA unless the caller names one.

    With no CUDA device and no explicit ``device`` this raises instead of
    carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ring_attention_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return torch.device("cuda")


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` with flax ``Dense(dtype=)`` semantics.

    ``weight`` is ``(out, in)`` float32 (the transpose of a flax kernel)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt))


class Embed(nn.Embedding):
    """Token embedding with flax ``Embed(dtype=)`` semantics."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__(num_embeddings, features, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        out = F.embedding(tokens, self.weight)
        return out if self.compute_dtype is None else out.to(self.compute_dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-12)
        return ((xf / rms) * self.gamma).to(x.dtype)


class FeedForward(nn.Module):
    """prenorm -> Dense(mult * dim) -> exact (erf) GELU -> Dense(dim)."""

    def __init__(self, dim: int, mult: int = 4, *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.norm = RMSNorm(dim, device=device)
        self.proj_in = Dense(dim, dim * mult, dtype=dtype, device=device)
        self.proj_out = Dense(dim * mult, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj_out(F.gelu(self.proj_in(self.norm(x))))
