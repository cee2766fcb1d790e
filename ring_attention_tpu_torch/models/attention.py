"""RingAttention: the attention layer, local and over a ring.

Port of ``ring_attention_tpu/models/attention.py``: fused qkv projection
after a prenorm, GQA heads, rotary, the local forward, prefill and KV-cache
decode entry points, and the ring strategy over a ``mesh``
(``parallel/mesh.py``).  The layer's kernel path is one field, ``impl``,
the counterpart of the JAX ``RingAttention._kernel_impl``:

- ``"cuda"`` (default; JAX ``"pallas"``): the hand-written CUDA flash kernels
  (``ops/cuda_flash.py``) for the forward (the ring's partials, resume and
  fused modes), its backward and decode;
- ``"torch"`` (JAX ``"xla"``): the blockwise PyTorch path (``ops/flash.py``,
  with its custom gradient) for the forward and backward, and the dense
  oracle for decode;
- ``"fused"`` (JAX ``"fused"``): the ring's forward on a fused ring
  kernel, whose tier ``parallel/ring.py`` picks as JAX does: without a key
  mask on a virtual ring, one launch for the whole ring in which the ranks
  pass KV to each other (``ops/cuda_ring_remote.py``); with one (a padded
  request), one launch per rank over the gathered KV
  (``ops/cuda_ring.py``); every local, prefill and decode path, and the
  ring's backward, run as under ``"cuda"`` (``_kernel_impl``, as the JAX
  layer's ``_use_pallas`` treats ``"fused"``).

Two int8 serving knobs, as in the JAX layer: ``quantize_cache`` keeps the
decode cache as int8 values with one f32 scale per ``(head, token)`` row
(cache entries are ``(values, scales)`` tuples; decode runs
``ops/cuda_flash_q8.py::flash_decode_q8`` on ``"cuda"`` and the dequantized
oracle on ``"torch"``), and ``compute_dtype="int8"`` runs the forward's QK^T
and PV on int8 operands (the int8 CUDA sweep, local and on the ring; the
backward stays on the float kernels).  ``compute_dtype="int8"`` needs
``impl="cuda"`` or ``"fused"``, as the JAX one needs the Pallas kernels;
under ``"fused"`` it runs locally only (the fused ring's int8 feed is not
ported yet, and a mesh of more than one rank raises).

On a mesh whose sequence world is above one the forward runs
``parallel/ring.py::ring_flash_attention`` with each rank's rotary
positions; with ``auto_shard`` the layer pads, stripes and unpermutes
around it.  ``forward(segment_ids=)`` packs documents into one row: a
query attends only keys of its own document, locally and on the
``"torch"``/``"cuda"`` ring (padding takes ``PAD_SEGMENT_ID``); rotary
positions stay global, as in the JAX layer (rotary is relative).  The
fused ring and the int8 sweep take no ids yet and raise.  The ring runs
on a mesh whose ring this process holds whole (a ``VirtualRing``: one
GPU, or the CPU).  ``prefill`` attends with
``ops/flash.py`` under either value, as the JAX package's does.  Features
not ported yet raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import PAD_SEGMENT_ID, default_attention
from ..ops.cuda_flash import cuda_flash_attention, cuda_flash_decode, int8_compute
from ..ops.cuda_flash_q8 import (
    QuantizedKV,
    dequantize_kv_cache,
    flash_decode_q8,
    quantize_kv_cache,
)
from ..ops.flash import flash_attention
from ..ops.rotary import apply_rotary, ring_positions, rotary_freqs
from ..parallel.mesh import seq_world
from ..parallel.ring import UNPORTED_FUSED_INT8, _fit_bucket, ring_flash_attention
from ..parallel.sharding import (
    layout_for,
    layout_permute,
    layout_unpermute,
    pad_seq_and_mask,
    pad_to_multiple,
)
from ..utils.validate import check_model_input
from .layers import Dense, RMSNorm, resolve_device

# Where each feature that is not ported yet will come from (ROADMAP.md).
UNPORTED = {
    "mask": "the mask algebra, ROADMAP.md Port queue item 7",
    "windowed_cache": "the memory knobs, ROADMAP.md Port queue item 7",
    "ff_chunk_size": "the memory knobs, ROADMAP.md Port queue item 7",
    "loss_chunk_size": "the memory knobs, ROADMAP.md Port queue item 7",
    "remat": "the memory knobs, ROADMAP.md Port queue item 7",
    "ring_bidirectional": "the ring variants, ROADMAP.md Port queue item 7",
    "ring_counter_rotate": "the ring variants, ROADMAP.md Port queue item 7",
    "ring_hop_compression": "the ring variants, ROADMAP.md Port queue item 7",
    "ring_dkv_dtype": "the ring variants, ROADMAP.md Port queue item 7",
    "decode": "tree-attention decoding on a mesh, ROADMAP.md Port queue item 7",
    "multiprocess": "the model over a multi-process mesh, ROADMAP.md Port queue item 6",
}
IMPLS = ("cuda", "torch", "fused")
UNPORTED_IMPLS = {
    "auto": "the degradation runtime (utils/resilience.py), ROADMAP.md Port queue item 7",
}


def reject_unported(fn: str, **settings) -> None:
    """Raise for any setting that asks for a feature not ported yet."""
    for name, value in settings.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{fn}: {name}= is not ported yet; it arrives with {UNPORTED[name]}"
            )


def unported(fn: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{fn}: {name} is not ported yet; it arrives with {UNPORTED[name]}"
    )


def check_compute_dtype(fn: str, compute_dtype, impl: str) -> None:
    """The int8-compute knob, validated as the JAX layer's
    ``_compute_dtype`` does: ``None`` or ``"int8"``, and ``"int8"`` only on
    the kernels (the PyTorch path has no int8 matmul form; running the
    quantized model in the model dtype would misreport it)."""
    if int8_compute(compute_dtype, fn) and impl == "torch":
        raise ValueError(
            f'{fn}: compute_dtype="int8" runs on the CUDA kernels only; set '
            f'impl="cuda" or "fused" (got impl="{impl}")'
        )


def check_fused_int8(fn: str, compute_dtype, impl: str, mesh) -> None:
    """The fused ring takes no int8 feed yet: ``compute_dtype="int8"`` under
    ``impl="fused"`` runs the local paths only, and a mesh of more than one
    rank raises at construction."""
    if impl == "fused" and compute_dtype == "int8" and seq_world(mesh) > 1:
        raise NotImplementedError(
            f'{fn}: compute_dtype="int8" on the fused ring (impl="fused" on a '
            f"mesh) is not ported yet; it arrives with {UNPORTED_FUSED_INT8}"
        )


def check_mesh(fn: str, mesh, sequence_parallel: str) -> None:
    """Raise for a mesh or strategy the port cannot run yet."""
    layout_for(sequence_parallel, False, 1)  # raises for unported strategies
    if mesh is not None and len(mesh.ring.ranks) != mesh.ring.world:
        raise unported(fn, "multiprocess")


def check_impl(fn: str, impl: str) -> None:
    if impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f'{fn}: impl="{impl}" is not ported yet; it arrives with '
            f"{UNPORTED_IMPLS[impl]}"
        )
    if impl not in IMPLS:
        raise ValueError(f"{fn}: impl must be one of {IMPLS}, got {impl!r}")


class RingAttention(nn.Module):
    """Attention layer ``x: (b, n, dim) -> (b, n, dim)``.

    Arguments mirror the JAX ``RingAttention`` fields; ``kv_heads`` sets
    GQA, ``max_lookback_seq_len`` a causal lookback window, ``dtype`` the
    compute dtype (parameters stay float32).  ``mesh`` runs the ring over
    the mesh's sequence ranks, in the ``striped`` layout when set;
    ``auto_shard`` takes ``x`` in the natural order and pads and permutes
    it for the ring (without it ``x`` arrives in the ring's layout)."""

    def __init__(
        self,
        dim: int,
        heads: int = 8,
        dim_head: int = 64,
        kv_heads: int | None = None,
        causal: bool = False,
        bucket_size: int = 512,
        rotary: bool = True,
        rotary_theta: float = 10000.0,
        softclamp_value: float | None = None,
        max_lookback_seq_len: int | None = None,
        impl: str = "cuda",
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        *,
        mesh=None,
        striped: bool = False,
        auto_shard: bool = False,
        sequence_parallel: str = "ring",
        mask=None,
        quantize_cache: bool = False,
        compute_dtype: str | None = None,
        ring_bidirectional: bool = False,
        ring_counter_rotate: bool = False,
        ring_hop_compression: str | None = None,
        ring_dkv_dtype: str | None = None,
    ):
        super().__init__()
        reject_unported("RingAttention", mask=mask,
                        ring_bidirectional=ring_bidirectional,
                        ring_counter_rotate=ring_counter_rotate,
                        ring_hop_compression=ring_hop_compression,
                        ring_dkv_dtype=ring_dkv_dtype)
        check_impl("RingAttention", impl)
        check_mesh("RingAttention", mesh, sequence_parallel)
        check_compute_dtype("RingAttention", compute_dtype, impl)
        check_fused_int8("RingAttention", compute_dtype, impl, mesh)
        kv_heads = kv_heads or heads
        if heads % kv_heads:
            raise ValueError(
                f"RingAttention: heads ({heads}) must be a multiple of "
                f"kv_heads ({kv_heads})"
            )
        device = resolve_device(device)
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.kv_heads = kv_heads
        self.causal = causal
        self.bucket_size = bucket_size
        self.rotary = rotary
        self.rotary_theta = rotary_theta
        self.softclamp_value = softclamp_value
        self.max_lookback_seq_len = max_lookback_seq_len
        self.impl = impl
        self.mesh = mesh
        self.striped = striped
        self.auto_shard = auto_shard
        self.quantize_cache = quantize_cache
        self.compute_dtype = compute_dtype
        self.prenorm = RMSNorm(dim, device=device)
        self.to_qkv = Dense(dim, (heads + 2 * kv_heads) * dim_head,
                            dtype=dtype, device=device)
        self.to_out = Dense(heads * dim_head, dim, dtype=dtype, device=device)

    @property
    def _kernel_impl(self) -> str:
        """The kernel path of every call but the ring's forward: ``"fused"``
        runs as ``"cuda"`` there (JAX ``_use_pallas``)."""
        return "cuda" if self.impl == "fused" else self.impl

    def _project_qkv(self, x: torch.Tensor):
        """prenorm + fused qkv -> heads-major (b, h|hk, n, dh)."""
        h, kvh, dh = self.heads, self.kv_heads, self.dim_head
        qkv = self.to_qkv(self.prenorm(x))
        q, k, v = qkv.split([h * dh, kvh * dh, kvh * dh], dim=-1)
        b, n, _ = x.shape
        q = q.reshape(b, n, h, dh).transpose(1, 2)
        k = k.reshape(b, n, kvh, dh).transpose(1, 2)
        v = v.reshape(b, n, kvh, dh).transpose(1, 2)
        return q, k, v

    def _rotate(self, q, k, positions: torch.Tensor):
        if not self.rotary:
            return q, k
        freqs = rotary_freqs(positions, self.dim_head, self.rotary_theta)
        return apply_rotary(q, freqs), apply_rotary(k, freqs)

    def _merge_heads(self, out: torch.Tensor) -> torch.Tensor:
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head))

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``x: (b, n, dim)`` -> ``(b, n, dim)``; ``mask: (b, n)`` key padding
        (True = attend), ignored when the layer is causal; ``segment_ids:
        (b, n)`` integer document ids of packed sequences."""
        check_model_input("RingAttention", x, self.dim)
        ring = seq_world(self.mesh) > 1
        n_orig = x.shape[1]
        scheme, factor = layout_for("ring", self.striped, seq_world(self.mesh))
        if ring and self.auto_shard:
            x, mask, n_orig = pad_seq_and_mask(x, mask, seq_world(self.mesh))
            x = layout_permute(x, scheme, factor)
            if mask is not None:
                mask = layout_permute(mask, scheme, factor)
            if segment_ids is not None:
                # pad slots are a document of their own, attending nothing real
                segment_ids, _ = pad_to_multiple(segment_ids, seq_world(self.mesh),
                                                 value=PAD_SEGMENT_ID)
                segment_ids = layout_permute(segment_ids, scheme, factor)
        q, k, v = self._project_qkv(x)
        if self.causal:
            mask = None
        attend = self._ring_attend if ring else self._local_attend
        out = self._merge_heads(attend(q, k, v, mask, segment_ids))
        if ring and self.auto_shard:
            out = layout_unpermute(out, scheme, factor)[:, :n_orig]
        return out

    def _ring_leg(self, n_chunk: int) -> tuple[int, int | None, int | None]:
        """``(bucket, window, max_ring_passes)`` for shards of ``n_chunk``:
        the bucket fitted to divide the shard, and a lookback turned into an
        exact window plus, in the contiguous layout, the hops that can hold
        in-window keys (``ceil((w - 1) / n_chunk)`` earlier shards and the
        own).  Striped, every hop holds some in-window key."""
        bucket = _fit_bucket(min(self.bucket_size, n_chunk), n_chunk)
        window = self.max_lookback_seq_len
        max_ring_passes = None
        if window is not None and not self.striped:
            max_ring_passes = math.ceil((window - 1) / n_chunk) + 1
        return bucket, window, max_ring_passes

    def _ring_attend(self, q, k, v, mask, segment_ids=None):
        ring = self.mesh.ring
        world = seq_world(self.mesh)
        n = q.shape[2]
        if n % world:
            raise ValueError(
                f"RingAttention: sequence {n} must divide over {world} (ring); "
                "use auto_shard=True to pad"
            )
        n_local = n // world
        bucket, window, max_ring_passes = self._ring_leg(n_local)
        if self.rotary:
            pos = torch.cat([
                ring_positions(n_local, rank, striped=self.striped, world=world,
                               device=q.device)
                for rank in ring.ranks
            ])
            q, k = self._rotate(q, k, pos)
        return ring_flash_attention(
            q, k, v, mask, ring, self.causal, self.striped, bucket,
            max_ring_passes, window, self.softclamp_value, None, self.impl,
            segment_ids=segment_ids, compute_dtype=self.compute_dtype,
        )

    def _local_attend(self, q, k, v, mask, segment_ids=None):
        n = q.shape[2]
        q, k = self._rotate(q, k, torch.arange(n, device=q.device))
        if self._kernel_impl == "cuda":
            return cuda_flash_attention(
                q, k, v, mask, causal=self.causal,
                window=self.max_lookback_seq_len,
                softclamp_value=self.softclamp_value,
                compute_dtype=self.compute_dtype, segment_ids=segment_ids,
            )
        return flash_attention(
            q, k, v, mask, causal=self.causal, bucket_size=self.bucket_size,
            window=self.max_lookback_seq_len,
            softclamp_value=self.softclamp_value, segment_ids=segment_ids,
        )

    # ------------------------------------------------------------------
    # Incremental decoding
    # ------------------------------------------------------------------

    def decode_step(
        self,
        x: torch.Tensor,  # (b, 1, dim): the new token's activation
        cache_k,  # (b, hk, size, dh); (values, scales) with quantize_cache
        cache_v,
        pos: int,  # position the new token occupies
    ):
        """One token of autoregressive decoding against a KV cache.

        Writes this token's K/V into slot ``pos % size`` of the ring-buffer
        cache IN PLACE (no copy of the cache per step) and attends the valid
        slots: positions ``[0, pos]``, restricted to the last
        ``max_lookback_seq_len`` when the layer has a window.  Under
        ``quantize_cache`` each cache entry is an ``(int8 values (b, hk,
        size, dh), f32 scales (b, hk, size))`` tuple and the new row is
        quantized as it is written.  Returns ``(out (b, 1, dim), cache_k,
        cache_v)``."""
        if seq_world(self.mesh) > 1:
            raise unported("RingAttention.decode_step", "decode")
        pos = int(pos)
        q, k, v = self._project_qkv(x)
        q, k = self._rotate(q, k, torch.tensor([pos], device=x.device))
        if self.quantize_cache:
            size = cache_k[0].shape[2]
            self._quantized_write(cache_k, cache_v, k, v, pos % size)
            kv = QuantizedKV(*cache_k, *cache_v)
            kv_mask = self._buffer_mask(size, pos, x.shape[0], x.device)
            if self._kernel_impl == "cuda":
                out, _ = flash_decode_q8(q, kv, kv_mask,
                                         softclamp_value=self.softclamp_value)
            else:
                k_deq, v_deq = dequantize_kv_cache(kv, q.dtype)
                out = default_attention(q, k_deq, v_deq, kv_mask,
                                        softclamp_value=self.softclamp_value)
            return self._merge_heads(out), cache_k, cache_v
        size = cache_k.shape[2]
        slot = pos % size
        cache_k[:, :, slot:slot + 1] = k.to(cache_k.dtype)
        cache_v[:, :, slot:slot + 1] = v.to(cache_v.dtype)
        kv_mask = self._buffer_mask(size, pos, x.shape[0], x.device)
        if self._kernel_impl == "cuda":
            # one sweep, each cache byte read once per kv head
            out, _ = cuda_flash_decode(
                q, cache_k, cache_v, kv_mask, softclamp_value=self.softclamp_value
            )
        else:
            out = default_attention(
                q, cache_k, cache_v, kv_mask, softclamp_value=self.softclamp_value
            )
        return self._merge_heads(out), cache_k, cache_v

    @staticmethod
    def _quantized_write(cache_k, cache_v, k, v, slot: int) -> None:
        """Quantize K/V rows ``(b, hk, n, dh)`` per token and write values
        and scales at slots ``[slot, slot + n)`` of ``(values, scales)``
        cache entries, in place (JAX ``_quantized_write``)."""
        kq, ks, vq, vs = quantize_kv_cache(k, v)
        n = k.shape[2]
        for (values, scales), q8, s in ((cache_k, kq, ks), (cache_v, vq, vs)):
            values[:, :, slot:slot + n] = q8
            scales[:, :, slot:slot + n] = s

    def _buffer_mask(self, size: int, pos: int, batch: int,
                     device: torch.device) -> torch.Tensor:
        """Valid-slot mask ``(batch, size)`` for a ring-buffer cache.

        Slot ``s`` holds the most recent position ``p_s <= pos`` with
        ``p_s ≡ s (mod size)``; it is valid when that position exists and
        sits inside the lookback window.  With ``size > pos`` this is the
        plain ``idx <= pos`` mask."""
        s = torch.arange(size, device=device)
        p = pos - ((pos - s) % size)
        keep = p >= 0
        if self.max_lookback_seq_len is not None:
            keep = keep & (p > pos - self.max_lookback_seq_len)
        return keep[None, :].expand(batch, size)

    def prefill(
        self,
        x: torch.Tensor,  # (b, n, dim): the whole prompt
        cache_k,  # (b, hk, size, dh); (values, scales) with quantize_cache
        cache_v,
    ):
        """One causal pass over the prompt, writing cache slots in place.

        The written K/V carry rotary exactly as ``decode_step`` writes them,
        so decoding continues from position ``n``.  Attention runs on the
        blockwise PyTorch path (``ops/flash.py``) on the exact K/V whatever
        ``impl`` and ``compute_dtype`` are, as in the JAX package; under
        ``quantize_cache`` only the cache is quantized.  Returns ``(out (b,
        n, dim), cache_k, cache_v)``."""
        if seq_world(self.mesh) > 1:
            raise unported("RingAttention.prefill", "decode")
        n = x.shape[1]
        size = (cache_k[0] if self.quantize_cache else cache_k).shape[2]
        lookback = self.max_lookback_seq_len
        if n > size and (lookback is None or size < lookback):
            raise ValueError(
                f"prefill: prompt ({n}) longer than the cache ({size}) "
                f"is only valid for a window-sized cache covering "
                f"max_lookback_seq_len ({lookback})"
            )
        q, k, v = self._project_qkv(x)
        q, k = self._rotate(q, k, torch.arange(n, device=x.device))
        out = flash_attention(
            q, k, v, causal=True, bucket_size=self.bucket_size,
            window=lookback, softclamp_value=self.softclamp_value,
        )
        if n > size:
            # keep the last `size` rows in ring-buffer slot order:
            # cache[s] = row at position p ≡ s (mod size)
            k_rows = torch.roll(k[:, :, n - size:], n % size, dims=2)
            v_rows = torch.roll(v[:, :, n - size:], n % size, dims=2)
        else:
            k_rows, v_rows = k, v
        if self.quantize_cache:
            self._quantized_write(cache_k, cache_v, k_rows, v_rows, 0)
        else:
            rows = k_rows.shape[2]
            cache_k[:, :, :rows] = k_rows.to(cache_k.dtype)
            cache_v[:, :, :rows] = v_rows.to(cache_v.dtype)
        return self._merge_heads(out), cache_k, cache_v
