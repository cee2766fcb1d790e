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
``impl="cuda"`` or ``"fused"``, as the JAX one needs the Pallas kernels.
``ring_hop_compression="int8"`` quantizes each rank's K/V once at ring
entry and circulates the int8 bytes (``parallel/ring.py``); with
``compute_dtype="int8"`` every hop's int8 sweep reads them with no
dequantize/requantize round trip (the dequant-free ring), and under
``"fused"`` the whole ring is one launch of the int8 remote tier where
there is no key mask and no ids.  The ring variants pass to every ring
leg (the ring, the hybrid's outer ring, the ring prefill):
``ring_bidirectional`` (an odd shard warns and runs unidirectional, JAX
``_bidirectional``), ``ring_counter_rotate`` (under ``impl="fused"`` the
ring runs the scan-path ``"cuda"`` ring, JAX ``_kernel_impl``) and
``ring_dkv_dtype``.

On a mesh whose sequence world is above one the forward runs
``parallel/ring.py::ring_flash_attention`` with each rank's rotary
positions, or with ``sequence_parallel="zigzag"``
``parallel/zigzag.py::zigzag_attention`` (causal only, no lookback, no
int8 compute; ``"fused"`` runs as ``"cuda"``), with ``"ulysses"``
``parallel/ulysses.py::ulysses_attention`` (the contiguous layout whatever
``striped`` says, no int8 compute; ``"fused"`` runs as ``"cuda"``), or
with ``"hybrid"`` on a factored mesh (``create_mesh(ulysses_size=U)``)
``parallel/hybrid.py::hybrid_attention`` (rotary from
``hybrid_positions`` before the all-to-all, the ring knobs sized against
the ring chunk, ``impl`` and the int8 knobs passed to the outer ring);
with ``auto_shard`` the layer pads, permutes (striped, at the outer
ring's degree for hybrid, or zig-zag) and unpermutes around it.  Every
strategy but hybrid runs on a plain mesh, hybrid only on a factored one.
``forward(segment_ids=)`` packs documents into one row: a query attends
only keys of its own document, locally and on the ``"torch"``/``"cuda"``
ring (padding takes ``PAD_SEGMENT_ID``); rotary positions stay global, as
in the JAX layer (rotary is relative).
``mask=`` takes a mask expression (``masks.py``, JAX ``mask=``) in place of
``causal``/``max_lookback_seq_len``: ``Causal() & DocumentMask(starts)``
declares a packing, which the local path keeps for the kernels' doc-tile
tables (``doc_starts``; certified first, ``masks.require_certified``) and
every ring realizes as runtime ids in the ring's layout (without a
certificate: the ring strategies' certificates are not ported), Ulysses
(which attends the whole span locally) as ``doc_starts`` again, and
``... & Segments()`` asks for ``segment_ids``; under ``compute_dtype="int8"``
the int8 sweep takes both (its segmented and doc-table instantiations).
The ring runs
on a mesh whose ring this process holds whole (a ``VirtualRing``: one
GPU, or the CPU) or one rank of (a ``DistributedRing`` per process, from
``create_mesh`` over an initialized process group): there ``x`` holds this
process's block of the sequence, or, with ``auto_shard``, the global
input, which the layer cuts to its rows and block and whose output it
gathers (``parallel/sharding.py::shard_cut`` / ``shard_gather``).
``use_ring=False`` or ``force_regular_attn`` turn the ring off, as in the
JAX layer (``force_regular_attn`` attends with the dense
``default_attention``); ``use_pallas`` is read as ``impl`` (True:
``"cuda"``, False: ``"torch"``) when ``impl`` is None.  Locally ``prefill`` attends with ``ops/flash.py``
under every ``impl``, as the JAX package's does; on a mesh it runs the
ring over the prompt in the contiguous layout (``_ring_prefill_attend``)
and ``decode_step`` keeps the cache sharded contiguously over the ranks,
one tensor per rank's shard that the kernels read in place, merging each rank's partials by tree attention
(``parallel/tree_decode.py``); on a factored mesh prefill and decode raise
``NotImplementedError``, as in JAX.  ``impl="auto"``, not ported yet,
raises ``NotImplementedError`` naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import math
import warnings

import torch
from torch import nn

from .. import masks as mask_algebra
from ..ops.attention import (
    PAD_SEGMENT_ID,
    check_doc_starts,
    default_attention,
    doc_runtime_ids,
)
from ..ops.cuda_flash import (
    cuda_flash_attention,
    cuda_flash_decode,
    int8_compute,
)
from ..ops.cuda_flash_q8 import (
    QuantizedKV,
    dequantize_kv_cache,
    flash_decode_q8,
    quantize_kv_cache,
)
from ..ops.flash import flash_attention
from ..ops.rotary import apply_rotary, hybrid_positions, ring_positions, rotary_freqs
from ..parallel.hybrid import hybrid_attention
from ..parallel.mesh import is_factored, seq_world
from ..parallel.ring import (
    HOP_COMPRESSIONS,
    _fit_bucket,
    _fit_divisor,
    ring_flash_attention,
)
from ..parallel.tree_decode import tree_attn_decode
from ..parallel.ulysses import ulysses_attention
from ..parallel.zigzag import zigzag_attention, zigzag_positions
from ..parallel.sharding import (
    layout_for,
    layout_permute,
    pad_seq_and_mask,
    pad_to_multiple,
    shard_cut,
    shard_gather,
)
from ..utils.validate import check_model_input
from .layers import Dense, RMSNorm, resolve_device

IMPLS = ("cuda", "torch", "fused")
UNPORTED_IMPLS = {
    "auto": "the degradation runtime (utils/resilience.py), ROADMAP.md Port queue item 7f",
}


def mask_form(fn: str, mask, causal: bool, lookback) -> mask_algebra.KernelForm | None:
    """A layer's mask expression resolved onto the kernel knobs (JAX
    ``RingAttention._mask_form``), or None without one.  It replaces
    ``causal=True`` and ``max_lookback_seq_len``, so passing either beside
    it raises, as in the JAX layer; a mask beyond the kernel surface raises
    ``masks.MaskLoweringError``."""
    if mask is None:
        return None
    if not isinstance(mask, mask_algebra.Mask):
        raise TypeError(f"{fn}: mask= takes a masks.Mask expression, got {type(mask).__name__}")
    if causal:
        raise ValueError(
            f"{fn}: mask= replaces causal=True (causal=True is sugar for "
            "mask=Causal()); set only one"
        )
    if lookback is not None:
        raise ValueError(
            f"{fn}: mask= replaces max_lookback_seq_len — compose "
            "SlidingWindow(w) into the mask instead"
        )
    return mask_algebra.kernel_form(mask)


def check_compute_dtype(fn: str, compute_dtype, impl: str,
                        force_regular_attn: bool = False) -> None:
    """The int8-compute knob, validated as the JAX layer's
    ``_compute_dtype`` does: ``None`` or ``"int8"``, and ``"int8"`` only on
    the kernels (the PyTorch path and the dense oracle of
    ``force_regular_attn`` have no int8 matmul form; running the quantized
    model in the model dtype would misreport it)."""
    if int8_compute(compute_dtype, fn) and (impl == "torch" or force_regular_attn):
        raise ValueError(
            f'{fn}: compute_dtype="int8" runs on the CUDA kernels only; set '
            f'impl="cuda" or "fused" and drop force_regular_attn (got impl="{impl}")'
        )


def check_hop_compression(fn: str, hop_compression) -> None:
    """The ring's wire knob: None or ``"int8"``, as the JAX ring takes it."""
    if hop_compression not in HOP_COMPRESSIONS:
        raise ValueError(
            f"{fn}: ring_hop_compression={hop_compression!r}; supported values "
            'are None (model-dtype hops) and "int8" (per-token absmax quantized hops)'
        )


def resolve_impl(impl: str | None, use_pallas: bool | None) -> str:
    """The kernel path: ``impl`` when given (it overrides ``use_pallas``,
    as in JAX), else the JAX switch ``use_pallas`` (True: the kernels,
    ``"cuda"``; False: the PyTorch path, ``"torch"``), else ``"cuda"``."""
    if impl is not None:
        return impl
    return "torch" if use_pallas is False else "cuda"


def check_constructor(fn: str, pallas_head_chunks, mesh, ring_on: bool) -> None:
    """The JAX constructor fields the port takes only in their neutral
    setting, and the ring switches a process mesh cannot take."""
    if pallas_head_chunks is not None:
        raise ValueError(
            f"{fn}: pallas_head_chunks splits a TPU launch's heads to bound its "
            "program size; the CUDA kernels have no counterpart (leave it None)"
        )
    if mesh is not None and mesh.spans_processes and not ring_on:
        raise ValueError(
            f"{fn}: use_ring=False or force_regular_attn on a mesh whose ranks are "
            "processes would run the whole sequence on every process; pass mesh=None"
        )


def check_mesh(fn: str, mesh, sequence_parallel: str, ring_on: bool,
               compute_dtype) -> None:
    """The strategy against the mesh, where the ring runs (JAX
    ``_check_mesh`` and the strategy test of ``_compute_dtype``): hybrid
    needs a factored mesh and every other strategy refuses one; int8
    compute runs on the ring, hybrid and local paths only."""
    layout_for(sequence_parallel, False, 1)  # an unknown strategy raises
    if not ring_on or seq_world(mesh) <= 1:
        return
    factored = is_factored(mesh)
    if sequence_parallel == "hybrid" and not factored:
        raise ValueError(
            f'{fn}: sequence_parallel="hybrid" needs a factored mesh — build it with '
            "create_mesh(ulysses_size=U, ring_size=R)"
        )
    if sequence_parallel != "hybrid" and factored:
        raise ValueError(
            f'{fn}: sequence_parallel="{sequence_parallel}" runs on a plain (data, seq) '
            'mesh; the factored (data, ring, ulysses) mesh is for sequence_parallel="hybrid"'
        )
    if compute_dtype == "int8" and sequence_parallel not in ("ring", "hybrid"):
        raise ValueError(
            f'{fn}: compute_dtype="int8" supports the "ring" strategy, the "hybrid" one '
            f'and the local path; got sequence_parallel="{sequence_parallel}"'
        )


def check_zigzag(fn: str, sequence_parallel: str, causal: bool, lookbacks) -> None:
    """Zig-zag balances causal work over a gathered span: causal only and no
    lookback window (the JAX layer's checks, its asserts made one-line
    errors)."""
    if sequence_parallel != "zigzag":
        return
    if not causal:
        raise ValueError(f'{fn}: sequence_parallel="zigzag" is causal only')
    if any(lb is not None for lb in lookbacks):
        raise ValueError(
            f'{fn}: sequence_parallel="zigzag" takes no max_lookback_seq_len'
        )


def check_factored_decode(fn: str, mesh) -> None:
    """Prefill and decode on a factored mesh raise, with JAX's words."""
    if is_factored(mesh):
        raise NotImplementedError(
            f"{fn}: ring-sharded prefill/decode runs on a plain (data, seq) mesh; the "
            "factored hybrid mesh is a training/forward layout — decode with "
            "create_mesh(ring_size=...)"
        )


def check_impl(fn: str, impl: str) -> None:
    if impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f'{fn}: impl="{impl}" is not ported yet; it arrives with '
            f"{UNPORTED_IMPLS[impl]}"
        )
    if impl not in IMPLS:
        raise ValueError(f"{fn}: impl must be one of {IMPLS}, got {impl!r}")


def _shard_slots(entry, quantized: bool) -> int:
    """The slots of one cache entry: a tensor ``(b, hk, slots, dh)`` or,
    quantized, a ``(values, scales)`` tuple."""
    return (entry[0] if quantized else entry).shape[2]


class RingAttention(nn.Module):
    """Attention layer ``x: (b, n, dim) -> (b, n, dim)``.

    Arguments mirror the JAX ``RingAttention`` fields; ``kv_heads`` sets
    GQA, ``max_lookback_seq_len`` a causal lookback window, ``dtype`` the
    compute dtype (parameters stay float32).  ``mesh`` runs the ring over
    the mesh's sequence ranks, in the ``striped`` layout when set;
    ``auto_shard`` takes ``x`` in the natural order and pads and permutes
    it for the ring (without it ``x`` arrives in the ring's layout: on a
    mesh whose ranks are processes, this process's block of it; with it,
    the global input, and the output is global too).
    ``mask`` (a ``masks.Mask``) replaces ``causal`` and
    ``max_lookback_seq_len``: its kernel form sets ``self.causal`` and
    ``self.max_lookback_seq_len``, and ``self.doc_starts`` to a declared
    packing.  ``use_ring=False`` and ``force_regular_attn`` run the local
    path on any mesh one process holds (``force_regular_attn``: the dense
    ``default_attention`` where no lookback window is set);
    ``use_pallas`` selects ``impl`` when that is None;
    ``pallas_head_chunks`` has no CUDA counterpart and must stay None."""

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
        impl: str | None = None,
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
        use_ring: bool = True,
        force_regular_attn: bool = False,
        use_pallas: bool | None = None,
        pallas_head_chunks: int | None = None,
        ring_bidirectional: bool = False,
        ring_counter_rotate: bool = False,
        ring_hop_compression: str | None = None,
        ring_dkv_dtype: str | None = None,
    ):
        super().__init__()
        check_hop_compression("RingAttention", ring_hop_compression)
        form = mask_form("RingAttention", mask, causal, max_lookback_seq_len)
        if form is not None:
            causal, max_lookback_seq_len = form.causal, form.window
        impl = resolve_impl(impl, use_pallas)
        check_impl("RingAttention", impl)
        ring_on = use_ring and not force_regular_attn
        check_mesh("RingAttention", mesh, sequence_parallel, ring_on, compute_dtype)
        check_constructor("RingAttention", pallas_head_chunks, mesh, ring_on)
        check_compute_dtype("RingAttention", compute_dtype, impl, force_regular_attn)
        check_zigzag("RingAttention", sequence_parallel, causal, (max_lookback_seq_len,))
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
        self.use_ring = use_ring
        self.force_regular_attn = force_regular_attn
        self.striped = striped
        self.sequence_parallel = sequence_parallel
        self.auto_shard = auto_shard
        self.quantize_cache = quantize_cache
        self.compute_dtype = compute_dtype
        self.ring_hop_compression = ring_hop_compression
        self.ring_bidirectional = ring_bidirectional
        self.ring_counter_rotate = ring_counter_rotate
        self.ring_dkv_dtype = ring_dkv_dtype
        self.mask = mask
        self.doc_starts = None if form is None else form.doc_starts
        self.needs_segment_ids = form is not None and form.needs_segment_ids
        self.prenorm = RMSNorm(dim, device=device)
        self.to_qkv = Dense(dim, (heads + 2 * kv_heads) * dim_head,
                            dtype=dtype, device=device)
        self.to_out = Dense(heads * dim_head, dim, dtype=dtype, device=device)

    @property
    def _ring_world(self) -> int:
        """The ring's size as this layer runs it: 1 when ``use_ring`` is
        off or ``force_regular_attn`` on (JAX ``ring = use_ring and not
        force_regular_attn and ...``)."""
        if not self.use_ring or self.force_regular_attn:
            return 1
        return seq_world(self.mesh)

    @property
    def _ulysses_size(self) -> int:
        return self.mesh.ulysses if is_factored(self.mesh) else 1

    @property
    def _kernel_impl(self) -> str:
        """The kernel path of every call but the ring's forward: ``"fused"``
        runs as ``"cuda"`` there (JAX ``_use_pallas``)."""
        return "cuda" if self.impl == "fused" else self.impl

    @property
    def _ring_impl(self) -> str:
        """The ring's kernel path: ``impl``, but ``"fused"`` runs the
        scan-path ``"cuda"`` ring under ``ring_counter_rotate``, whose
        alternating schedule has no fused form (JAX ``_kernel_impl``)."""
        if self.impl == "fused" and self.ring_counter_rotate:
            return "cuda"
        return self.impl

    def _bidirectional(self, n_local: int) -> bool:
        """Bidirectional streams need an even shard: on an odd one warn and
        run the unidirectional ring, so that a benchmark is not misread
        (JAX ``_bidirectional``)."""
        if self.ring_bidirectional and n_local % 2:
            warnings.warn(
                f"ring_bidirectional requested but the per-device sequence length "
                f"({n_local}) is odd; running the unidirectional ring",
                stacklevel=3,
            )
            return False
        return self.ring_bidirectional

    def _ring_knobs(self, n_local: int) -> dict:
        """The ring variants' keywords for shards of ``n_local``, as every
        ring leg passes them (JAX :603-627, :646-667, :899-914)."""
        return dict(bidirectional=self._bidirectional(n_local), dkv_dtype=self.ring_dkv_dtype,
                    counter_rotate=self.ring_counter_rotate,
                    hop_compression=self.ring_hop_compression)

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
        world = self._ring_world
        ring = world > 1
        n_orig = x.shape[1]
        scheme, factor = layout_for(self.sequence_parallel, self.striped, world,
                                    self._ulysses_size)
        ulysses = ring and self.sequence_parallel == "ulysses"
        if self.needs_segment_ids and segment_ids is None:
            raise ValueError(
                "RingAttention: the mask includes Segments() — pass the runtime "
                "segment_ids array"
            )
        if self.doc_starts is not None:
            if segment_ids is not None:
                raise ValueError(
                    "RingAttention: the mask declares a DocumentMask layout AND "
                    "segment_ids were passed — declare one packing"
                )
            if ring and not ulysses:
                # the ring realizes the declared layout as runtime ids over the
                # global batch and sequence, in its layout: auto_shard pads,
                # permutes and cuts them with x below; otherwise x came
                # padded at its end, permuted and cut, and so do they
                # (Ulysses attends the whole span: its kernels take doc_starts)
                rows, n = x.shape[0], n_orig
                if not self.auto_shard:
                    rows *= self.mesh.data
                    n = n // len(self.mesh.seq_ranks) * world
                starts = check_doc_starts(self.doc_starts, n, n)
                segment_ids = doc_runtime_ids(starts, n, rows, x.device)
                if not self.auto_shard:
                    segment_ids = shard_cut(layout_permute(segment_ids, scheme, factor),
                                            self.mesh)
        if ring and self.auto_shard:
            pad_mult = 2 * world if scheme == "zigzag" else world
            x, mask, n_orig = pad_seq_and_mask(x, mask, pad_mult)
            x = shard_cut(layout_permute(x, scheme, factor), self.mesh)
            if mask is not None:
                mask = shard_cut(layout_permute(mask, scheme, factor), self.mesh)
            if segment_ids is not None:
                # pad slots are a document of their own, attending nothing real
                segment_ids, _ = pad_to_multiple(segment_ids, pad_mult,
                                                 value=PAD_SEGMENT_ID)
                segment_ids = shard_cut(layout_permute(segment_ids, scheme, factor),
                                        self.mesh)
        q, k, v = self._project_qkv(x)
        if self.causal:
            mask = None
        attend = self._local_attend
        if ring:
            attend = {"zigzag": self._zigzag_attend, "ulysses": self._ulysses_attend,
                      "hybrid": self._hybrid_attend}.get(self.sequence_parallel,
                                                         self._ring_attend)
        out = self._merge_heads(attend(q, k, v, mask, segment_ids))
        if ring and self.auto_shard:
            out = shard_gather(out, self.mesh, scheme, factor)[:, :n_orig]
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
        """The ring over ``q``, which holds the shards of the ranks this
        process holds (every rank's on a ``VirtualRing``)."""
        ring = self.mesh.ring
        world, count = ring.world, len(ring.ranks)
        n = q.shape[2]
        if n % count:
            raise ValueError(
                f"RingAttention: sequence {n} must divide over {count} (ring); "
                "use auto_shard=True to pad"
            )
        n_local = n // count
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
            max_ring_passes, window, self.softclamp_value, None, self._ring_impl,
            segment_ids=segment_ids, compute_dtype=self.compute_dtype,
            **self._ring_knobs(n_local),
        )

    def _held_shard(self, n: int, count: int) -> int:
        """The shard length of ``n`` rows over ``count`` held ranks."""
        if n % count:
            raise ValueError(
                f"RingAttention: sequence {n} must divide over {count} "
                f"({self.sequence_parallel}); use auto_shard=True to pad"
            )
        return n // count

    def _ulysses_attend(self, q, k, v, mask, segment_ids=None):
        """Ulysses over the mesh's ring (JAX ``_ulysses_attend``, :557-586):
        each held rank's contiguous rotary positions, then the all-to-alls
        around the whole span's local flash; a declared packing reaches the
        kernels as ``doc_starts``, certified over the whole span."""
        ring = self.mesh.ring
        n_local = self._held_shard(q.shape[2], len(ring.ranks))
        if self.rotary:
            pos = torch.cat([ring_positions(n_local, rank, striped=False, world=ring.world,
                                            device=q.device) for rank in ring.ranks])
            q, k = self._rotate(q, k, pos)
        if self.mask is not None:
            mask_algebra.require_certified(self.mask, n_local * ring.world)
        return ulysses_attention(
            q, k, v, ring, causal=self.causal, kv_mask=mask, bucket_size=self.bucket_size,
            window=self.max_lookback_seq_len, softclamp_value=self.softclamp_value,
            impl=self._kernel_impl, segment_ids=segment_ids,
            doc_starts=None if segment_ids is not None else self.doc_starts,
        )

    def _hybrid_attend(self, q, k, v, mask, segment_ids=None):
        """Ulysses x Ring over the factored mesh (JAX ``_hybrid_attend``,
        :588-630): rotary on the resident shards from the combined rank
        (``hybrid_positions``), the ring knobs sized against the ring chunk
        ``U * n_local``, and ``impl`` and the int8 knobs on the outer ring."""
        mesh = self.mesh
        ring, uring, u = mesh.ring, mesh.ulysses_ring, mesh.ulysses
        n_local = self._held_shard(q.shape[2], len(mesh.seq_ranks))
        bucket, window, max_ring_passes = self._ring_leg(u * n_local)
        if self.rotary:
            pos = torch.cat([
                hybrid_positions(n_local, j, r, ulysses=u, ring=ring.world,
                                 striped=self.striped, device=q.device)
                for r in ring.ranks for j in uring.ranks
            ])
            q, k = self._rotate(q, k, pos)
        return hybrid_attention(
            q, k, v, mask, uring, ring, causal=self.causal, striped=self.striped,
            bucket_size=bucket, max_ring_passes=max_ring_passes, window=window,
            softclamp_value=self.softclamp_value, impl=self._ring_impl,
            segment_ids=segment_ids, compute_dtype=self.compute_dtype,
            **self._ring_knobs(u * n_local),
        )

    def _zigzag_attend(self, q, k, v, mask, segment_ids=None):
        """Zig-zag over the mesh's ring: each held rank's rotary positions
        from its two chunks (JAX ``_zigzag_attend``, :530-556).  ``mask`` is
        None: the layer is causal."""
        ring = self.mesh.ring
        world, count = ring.world, len(ring.ranks)
        n = q.shape[2]
        if n % (2 * count):
            raise ValueError(
                f"RingAttention: sequence {n} must divide over {2 * count} "
                "(zigzag); use auto_shard=True to pad"
            )
        n_local = n // count
        if self.rotary:
            pos = torch.cat([zigzag_positions(n_local, rank, world, device=q.device)
                             for rank in ring.ranks])
            q, k = self._rotate(q, k, pos)
        return zigzag_attention(
            q, k, v, ring, bucket_size=self.bucket_size,
            softclamp_value=self.softclamp_value, impl=self._kernel_impl,
            segment_ids=segment_ids,
        )

    def _local_attend(self, q, k, v, mask, segment_ids=None):
        """One sweep; a declared packing goes to the kernels as
        ``doc_starts`` (their doc-tile tables, certified first) and to the
        PyTorch path as runtime ids."""
        n = q.shape[2]
        q, k = self._rotate(q, k, torch.arange(n, device=q.device))
        if self.mask is not None:
            mask_algebra.require_certified(self.mask, n)
        if self.force_regular_attn and self.max_lookback_seq_len is None:
            return default_attention(
                q, k, v, mask, causal=self.causal, softclamp_value=self.softclamp_value,
                segment_ids=segment_ids, doc_starts=self.doc_starts,
            )
        if self._kernel_impl == "cuda":
            return cuda_flash_attention(
                q, k, v, mask, causal=self.causal,
                window=self.max_lookback_seq_len,
                softclamp_value=self.softclamp_value,
                compute_dtype=self.compute_dtype, segment_ids=segment_ids,
                doc_starts=self.doc_starts,
            )
        return flash_attention(
            q, k, v, mask, causal=self.causal, bucket_size=self.bucket_size,
            window=self.max_lookback_seq_len,
            softclamp_value=self.softclamp_value, segment_ids=segment_ids,
            doc_starts=self.doc_starts,
        )

    # ------------------------------------------------------------------
    # Incremental decoding
    # ------------------------------------------------------------------

    def decode_step(
        self,
        x: torch.Tensor,  # (b, 1, dim): the new token's activation
        cache_k,  # (b, hk, size, dh); (values, scales) with quantize_cache;
        # on a mesh, a list of such entries, one per rank's shard
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
        quantized as it is written.  On a mesh the cache is a list of
        such entries, one per rank's shard, sharded contiguously over the
        ring: it holds absolute positions (:meth:`_ring_decode`).  Returns ``(out (b, 1, dim), cache_k,
        cache_v)``."""
        pos = int(pos)
        if self._ring_world > 1:
            check_factored_decode("decode_step", self.mesh)
        q, k, v = self._project_qkv(x)
        q, k = self._rotate(q, k, torch.tensor([pos], device=x.device))
        if self._ring_world > 1:
            out = self._ring_decode(q, k, v, cache_k, cache_v, pos)
            return self._merge_heads(out), cache_k, cache_v
        size = _shard_slots(cache_k, self.quantize_cache)
        self._write(cache_k, cache_v, k, v, pos % size)
        kv_mask = self._buffer_mask(size, pos, x.shape[0], x.device)
        if self.quantize_cache:
            kv = QuantizedKV(*cache_k, *cache_v)
            if self._kernel_impl == "cuda":
                out, _ = flash_decode_q8(q, kv, kv_mask,
                                         softclamp_value=self.softclamp_value)
            else:
                k_deq, v_deq = dequantize_kv_cache(kv, q.dtype)
                out = default_attention(q, k_deq, v_deq, kv_mask,
                                        softclamp_value=self.softclamp_value)
        elif self._kernel_impl == "cuda":
            # one sweep, each cache byte read once per kv head
            out, _ = cuda_flash_decode(
                q, cache_k, cache_v, kv_mask, softclamp_value=self.softclamp_value
            )
        else:
            out = default_attention(
                q, cache_k, cache_v, kv_mask, softclamp_value=self.softclamp_value
            )
        return self._merge_heads(out), cache_k, cache_v

    def _ring_decode(self, q, k, v, cache_k, cache_v, pos: int) -> torch.Tensor:
        """Decode against a cache sharded contiguously over the ring (JAX
        ``_ring_decode``, :928-999): rank ``pos // n_local`` owns the new
        row and writes it at its local slot ``pos % n_local``; every rank
        attends its shard under the absolute-position mask
        (:meth:`_decode_mask`) and the shards' partials merge by tree
        attention.  ``cache_k``, ``cache_v``: one shard per rank this
        process holds, in rank order (every rank's on a ``VirtualRing``),
        each a ``(b, hk, n_local, dh)`` tensor or, with ``quantize_cache``,
        a ``(values, scales)`` tuple.  Returns ``(b, h, 1, dh)``."""
        ring = self.mesh.ring
        world = seq_world(self.mesh)
        n_local = _shard_slots(cache_k[0], self.quantize_cache)
        if pos >= n_local * world:
            raise ValueError(
                f"decode_step: position {pos} is past the ring-sharded cache of "
                f"{n_local * world} slots (it holds absolute positions)"
            )
        owner = pos // n_local
        if owner in ring.ranks:
            j = ring.ranks.index(owner)
            self._write(cache_k[j], cache_v[j], k, v, pos % n_local)
        # the held ranks are consecutive (every rank, or one)
        idx = ring.ranks[0] * n_local + torch.arange(
            len(ring.ranks) * n_local, device=q.device).view(len(ring.ranks), n_local)
        masks = list(self._decode_mask(idx, pos, q.shape[0]))
        if self.quantize_cache:
            # impl="torch" dequantizes inside tree_attn_decode
            return tree_attn_decode(
                q, None, None, masks, ring=ring, softclamp_value=self.softclamp_value,
                impl=self._kernel_impl,
                kv_quantized=[QuantizedKV(*ck, *cv) for ck, cv in zip(cache_k, cache_v)],
            )
        return tree_attn_decode(
            q, cache_k, cache_v, masks, ring=ring,
            softclamp_value=self.softclamp_value, impl=self._kernel_impl,
        )

    def _decode_mask(self, idx: torch.Tensor, pos: int, batch: int) -> torch.Tensor:
        """Valid-slot masks ``(ranks, batch, n_local)`` of a ring-sharded
        cache, one contiguous tensor (each rank's mask a contiguous slice of
        it, which the decode kernels read in place): ``idx (ranks,
        n_local)`` are the slots' absolute positions; valid are ``[0,
        pos]``, windowed to the last ``max_lookback_seq_len`` when set."""
        keep = idx <= pos
        if self.max_lookback_seq_len is not None:
            keep = keep & (idx > pos - self.max_lookback_seq_len)
        return keep[:, None, :].expand(idx.shape[0], batch, idx.shape[1]).contiguous()

    def _write(self, cache_k, cache_v, k, v, slot: int) -> None:
        """Write K/V rows ``(b, hk, n, dh)`` at slots ``[slot, slot + n)`` of
        a cache entry, in place, quantized under ``quantize_cache``."""
        if self.quantize_cache:
            self._quantized_write(cache_k, cache_v, k, v, slot)
        else:
            n = k.shape[2]
            cache_k[:, :, slot:slot + n] = k.to(cache_k.dtype)
            cache_v[:, :, slot:slot + n] = v.to(cache_v.dtype)

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
        cache_k,  # (b, hk, size, dh); (values, scales) with quantize_cache;
        # on a mesh, a list of such entries, one per rank's shard
        cache_v,
    ):
        """One causal pass over the prompt, writing cache slots in place.

        The written K/V carry rotary exactly as ``decode_step`` writes them,
        so decoding continues from position ``n``.  Attention runs on the
        blockwise PyTorch path (``ops/flash.py``) on the exact K/V whatever
        ``impl`` and ``compute_dtype`` are, as in the JAX package; on a mesh
        it runs the ring over the prompt (:meth:`_mesh_prefill`): on a mesh
        whose ranks are processes ``x`` is the global prompt, of which this
        process's rows and block go through the ring and whose output is
        gathered.  Under ``quantize_cache`` only the cache is quantized.
        Returns ``(out (b, n, dim), cache_k, cache_v)``."""
        n = x.shape[1]
        lookback = self.max_lookback_seq_len
        world = self._ring_world
        if world > 1:
            check_factored_decode("prefill", self.mesh)
            if not self.mesh.spans_processes:
                return self._mesh_prefill(x, cache_k, cache_v, n), cache_k, cache_v
            block = shard_cut(pad_to_multiple(x, world)[0], self.mesh)
            out = self._mesh_prefill(block, cache_k, cache_v, n)
            return shard_gather(out, self.mesh)[:, :n], cache_k, cache_v
        size = _shard_slots(cache_k, self.quantize_cache)
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
            k = torch.roll(k[:, :, n - size:], n % size, dims=2)
            v = torch.roll(v[:, :, n - size:], n % size, dims=2)
        self._write(cache_k, cache_v, k, v, 0)
        return self._merge_heads(out), cache_k, cache_v

    def _mesh_prefill(self, x, cache_k, cache_v, n: int) -> torch.Tensor:
        """Prefill on a mesh: ``x (b, m, dim)`` holds the prompt from the
        first held rank's block on, the prompt (of ``n`` tokens) padded to
        the ring in blocks of ``p = ceil(n / world)``: every rank's on a
        ``VirtualRing`` (there ``x`` may stop at the prompt's end), this
        rank's block on a process.  The blocks go through the ring
        (:meth:`_ring_prefill_attend`); each held rank's cache shard,
        positions ``[r * n_local, (r + 1) * n_local)``, is written from the
        prompt's K/V, all-gathered over the ring on a process (the prompt's
        blocks and the cache's shards are cut apart).  Returns the output
        ``(b, m, dim)`` of ``x``'s rows."""
        ring = self.mesh.ring
        world, count = ring.world, len(ring.ranks)
        n_local = _shard_slots(cache_k[0], self.quantize_cache)
        if n > n_local * world:
            raise ValueError(
                f"prefill: prompt ({n}) longer than the ring-sharded cache "
                f"({n_local * world}), which holds absolute positions"
            )
        m, p = x.shape[1], -(-n // world)
        q, k, v = self._project_qkv(x)
        q, k = self._rotate(q, k, ring.ranks[0] * p + torch.arange(m, device=x.device))
        if count * p > m:
            # right-padded to the ring: causal masking hides the pad, which
            # sits after every real query, and its rows are sliced off
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, count * p - m))
                       for t in (q, k, v))
        out = self._ring_prefill_attend(q, k, v, p)[:, :, :m]
        if ring.spans_processes:
            k, v = ring.all_gather([(k, v)], dim=2)[0]
        for j, r in enumerate(ring.ranks):
            rows = slice(r * n_local, min(n, (r + 1) * n_local))
            if rows.start < rows.stop:
                self._write(cache_k[j], cache_v[j], k[:, :, rows], v[:, :, rows], 0)
        return self._merge_heads(out)

    def _ring_prefill_attend(self, q, k, v, n_local: int) -> torch.Tensor:
        """The ring over the prompt's blocks of ``n_local`` in the contiguous
        (cache) layout, whatever ``striped`` and ``sequence_parallel`` say
        (JAX ``_ring_prefill_attend``, :872-927); rotary is applied.  Runs
        ``impl`` as it stands (``"fused"`` takes the fused ring, but the
        scan ring under ``ring_counter_rotate``) and the ring variants, as
        JAX does, and never int8 compute."""
        bucket = _fit_divisor(self.bucket_size, n_local)
        window = self.max_lookback_seq_len
        max_ring_passes = None
        if window is not None:
            max_ring_passes = math.ceil((window - 1) / n_local) + 1
        return ring_flash_attention(
            q, k, v, None, self.mesh.ring, True, False, bucket, max_ring_passes,
            window, self.softclamp_value, None, self._ring_impl, **self._ring_knobs(n_local),
        )
