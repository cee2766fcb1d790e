"""Transformer building blocks: Dense, Embed, RMSNorm and FeedForward.

Ports of ``ring_attention_tpu/models/layers.py:34-150`` and of the flax
``nn.Dense``/``nn.Embed`` semantics the JAX model relies on: parameters are
kept in float32 and cast to the module's compute ``dtype`` at use (with
``dtype=None`` the computation runs in the promoted input/parameter type,
float32 here).  Norm statistics are float32 whatever the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.residuals import checkpoint_name
from .remat import remat_call


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
    """prenorm -> Dense(mult * dim) -> exact (erf) GELU -> Dense(dim).

    ``chunk_size`` runs the blockwise feedforward (JAX ``FeedForward(
    chunk_size=, seq_shards=)``, ``models/layers.py:85-150``): the sequence
    is cut into chunks of ``chunk_size`` positions, each run under its own
    checkpoint, so that the ``(b, chunk, mult * dim)`` intermediate exists
    for one chunk at a time, in the forward and the backward.  Chunks are
    taken within each of ``seq_shards`` sequence shards (the ring's layout:
    chunk ``i`` is every shard's chunk ``i``); a shard length that does not
    divide is padded up and the padding sliced off; a chunk of at least the
    shard length (a decode step's single token, say) runs the dense block.
    The post-norm input is the residual ``ffn_in`` that the remat policies
    ``save_ffn_inputs`` and ``save_attn_and_ffn_inputs`` keep."""

    def __init__(self, dim: int, mult: int = 4, *,
                 dtype: torch.dtype | None = None, device=None,
                 chunk_size: int | None = None, seq_shards: int = 1):
        super().__init__()
        self.norm = RMSNorm(dim, device=device)
        self.proj_in = Dense(dim, dim * mult, dtype=dtype, device=device)
        self.proj_out = Dense(dim * mult, dim, dtype=dtype, device=device)
        self.chunk_size = chunk_size
        self.seq_shards = max(seq_shards, 1)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        h = checkpoint_name(self.norm(x), "ffn_in")
        return self.proj_out(F.gelu(self.proj_in(h)))

    def chunk_for(self, n: int) -> int | None:
        """The chunk the blockwise path takes on ``n`` positions, or None
        where the layer runs dense (no ``chunk_size``, shards that do not
        divide ``n``, or a chunk of at least one shard)."""
        c, shards = self.chunk_size, self.seq_shards
        if c is None or c <= 0 or n % shards:
            return None
        c = min(c, n // shards)
        return c if c < n // shards else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.chunk_for(x.shape[1])
        if c is None:
            return self._block(x)
        b, n, d = x.shape
        shards = self.seq_shards
        n_local = n // shards
        pad = -n_local % c
        xs = x.reshape(b, shards, n_local, d)
        if pad:
            xs = F.pad(xs, (0, 0, 0, pad))
        # each chunk a plain checkpoint: its body is recomputed in the
        # backward whatever the layer's remat policy (JAX's scanned remat)
        out = torch.cat([remat_call(None, self._block, xs[:, :, i:i + c])
                         for i in range(0, n_local + pad, c)], dim=2)
        if pad:
            out = out[:, :, :n_local]
        return out.reshape(b, n, d)
