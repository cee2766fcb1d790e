"""Attention ops: the single-device entry point :func:`attention` (a mask
expression or the classic knobs), the dense oracle, rotary, the blockwise
PyTorch flash path, the partial-state ops, the int8 codec and the host side
of the CUDA flash kernels (forward in its fused, partials and resume modes;
dk/dv; dq; the int8 forward and the int8 decode) and of the fused ring
kernels (local and remote tier)."""

from .attention import (
    EPSILON,
    MASK_VALUE,
    PAD_SEGMENT_ID,
    SegmentIds,
    default_attention,
    normalize_segment_ids,
    segments_overlap,
    softclamp,
)
from .cuda_flash import (
    cuda_flash_attention,
    int8_compute,
    cuda_flash_decode,
    flash_bwd,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
    flash_partials,
    flash_partials_reference,
)
from .cuda_flash_q8 import (
    Int8KV,
    QuantizedKV,
    dequantize_kv_cache,
    flash_decode_q8,
    flash_decode_q8_reference,
    flash_fwd_q8,
    flash_fwd_q8_reference,
    flash_partials_q8,
    flash_partials_q8_reference,
    kernel_kv,
    q8_block,
    quantize_kv_cache,
    quantize_kv_feed,
)
from .cuda_ring import fused_ring_local, fused_ring_local_plain
from .cuda_ring_remote import fused_ring_remote, fused_ring_remote_plain
from .flash import (
    FlashCarry,
    attend_blocks,
    finalize,
    flash_attention,
    flash_backward_blocks,
    init_carry,
)
from .partials import FlashPartials, finalize_partials, init_partials, merge_partials
from .quant import (
    INT8_MAX,
    QuantizedBlockKV,
    dequantize_blocks,
    dequantize_rows,
    pack_kv,
    payload_kernel_feed,
    quantize_blocks,
    quantize_kv_blocks,
    quantize_p,
    quantize_rows,
    unpack_kv,
)
from .rotary import apply_rotary, hybrid_positions, ring_positions, rotary_freqs, rotate_half
from .. import masks as _masks
from ..utils.validate import check_attention_args as _check_attention_args

# The entry point's kernel paths (JAX "pallas" and "xla"); "auto" needs the
# degradation runtime, which is not ported.
ATTENTION_IMPLS = ("cuda", "torch")
UNPORTED_AUTO = ("the degradation runtime (utils/resilience.py), ROADMAP.md Port "
                 "queue item 7f")


def attention(
    q,
    k,
    v,
    mask=None,
    *,
    causal: bool = False,
    window: int | None = None,
    softclamp_value: float | None = None,
    impl: str = "cuda",
    bucket_size: int | None = None,
    segment_ids=None,
    doc_starts: tuple[int, ...] | None = None,
    compute_dtype: str | None = None,
):
    """Single-device attention entry point (JAX ``ops.attention``, :33-200).

    ``mask`` takes a ``(b, nk)`` boolean key-padding tensor or a
    :class:`~ring_attention_tpu_torch.masks.Mask` expression, e.g.
    ``attention(q, k, v, mask=Causal() & DocumentMask(starts))``.  An
    expression goes through ``masks.kernel_form`` onto the kernel knobs
    (``causal=True`` is sugar for ``Causal()``) and replaces ``causal=``,
    ``window=`` and ``doc_starts=`` (passing both raises); on
    self-attention its tiles are certified first
    (``masks.require_certified``, cached).  Expressions beyond the kernel
    surface raise :class:`~ring_attention_tpu_torch.masks.MaskLoweringError`.

    ``impl``: ``"cuda"`` (JAX ``"pallas"``) runs ``cuda_flash_attention``,
    where a declared ``doc_starts`` packing drops the tiles of other
    documents; ``"torch"`` (JAX ``"xla"``) runs ``flash_attention``, which
    realizes the packing as runtime ids.  ``"auto"`` is not ported yet.
    ``segment_ids`` packs documents at run time on both paths;
    ``compute_dtype="int8"`` runs on ``"cuda"`` only."""
    attn_mask = None
    if isinstance(mask, _masks.Mask):
        attn_mask, mask = mask, None  # the padding-mask slot stays empty
    _check_attention_args("attention", q, k, v, mask)
    if impl == "auto":
        raise NotImplementedError(
            f'attention: impl="auto" is not ported yet; it arrives with {UNPORTED_AUTO}'
        )
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention: impl must be one of {ATTENTION_IMPLS}, got {impl!r}")
    if attn_mask is not None:
        if causal or window is not None:
            raise ValueError(
                "attention: a mask expression subsumes causal=/window= — "
                "compose them into the mask (causal=True is sugar for "
                "Causal())"
            )
        form = _masks.kernel_form(attn_mask)  # raises MaskLoweringError
        causal, window = form.causal, form.window
        if form.doc_starts is not None:
            if doc_starts is not None:
                raise ValueError(
                    "attention: the mask already declares a DocumentMask "
                    "packing; drop the doc_starts= argument"
                )
            doc_starts = form.doc_starts
        if form.needs_segment_ids and segment_ids is None:
            raise ValueError(
                "attention: the mask includes Segments() — pass the "
                "runtime segment_ids array"
            )
        if q.shape[2] == k.shape[2]:
            # the tiles this call visits, certified against the mask's
            # oracle (cached); cross-attention has no self-attention grid
            _masks.require_certified(attn_mask, q.shape[2])
    if compute_dtype is not None and impl == "torch":
        int8_compute(compute_dtype, "attention")
        raise ValueError(
            'attention: compute_dtype="int8" runs on the CUDA kernels only, but '
            'impl="torch" takes the PyTorch path — a silent float fallback would '
            "misreport a quantized run"
        )
    if impl == "torch":
        return flash_attention(
            q, k, v, mask, causal=causal, bucket_size=bucket_size, window=window,
            softclamp_value=softclamp_value, segment_ids=segment_ids,
            doc_starts=doc_starts,
        )
    return cuda_flash_attention(
        q, k, v, mask, causal=causal, window=window, softclamp_value=softclamp_value,
        compute_dtype=compute_dtype, segment_ids=segment_ids, doc_starts=doc_starts,
    )


__all__ = [
    "ATTENTION_IMPLS",
    "attention",
    "EPSILON",
    "INT8_MAX",
    "MASK_VALUE",
    "PAD_SEGMENT_ID",
    "FlashCarry",
    "FlashPartials",
    "Int8KV",
    "QuantizedBlockKV",
    "QuantizedKV",
    "SegmentIds",
    "apply_rotary",
    "attend_blocks",
    "cuda_flash_attention",
    "cuda_flash_decode",
    "default_attention",
    "dequantize_blocks",
    "dequantize_kv_cache",
    "dequantize_rows",
    "finalize",
    "finalize_partials",
    "flash_attention",
    "flash_backward_blocks",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_reference",
    "flash_decode_q8",
    "flash_decode_q8_reference",
    "flash_fwd",
    "flash_fwd_q8",
    "flash_fwd_q8_reference",
    "flash_fwd_reference",
    "flash_partials",
    "flash_partials_q8",
    "flash_partials_q8_reference",
    "flash_partials_reference",
    "fused_ring_local",
    "fused_ring_local_plain",
    "fused_ring_remote",
    "fused_ring_remote_plain",
    "hybrid_positions",
    "init_carry",
    "init_partials",
    "kernel_kv",
    "merge_partials",
    "normalize_segment_ids",
    "pack_kv",
    "payload_kernel_feed",
    "q8_block",
    "quantize_blocks",
    "quantize_kv_blocks",
    "quantize_kv_cache",
    "quantize_kv_feed",
    "quantize_p",
    "quantize_rows",
    "ring_positions",
    "rotary_freqs",
    "rotate_half",
    "segments_overlap",
    "softclamp",
    "unpack_kv",
]
