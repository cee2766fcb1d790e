"""ring_attention_tpu_torch: the PyTorch/CUDA port of ring_attention_tpu.

The port covers the single-device serving path of ``RingTransformer``
(forward logits, ``prefill``, KV-cache ``decode_step``, ``generate``) on a
hand-written CUDA flash-forward kernel for Hopper (``csrc/flash_fwd.cu``),
its training path (``loss.backward()`` and ``make_train_step``) on the
hand-written dk/dv and dq kernels (``csrc/flash_bwd.cu``), and the ring
(``parallel/``: ``ring_flash_attention`` forward and backward over a
``VirtualRing`` or a ``DistributedRing``, and ``RingTransformer(mesh=)``
on a virtual ring) on the forward kernel's partials and resume modes,
and int8 serving (``RingTransformer(quantize_cache=True,
compute_dtype="int8")``: the int8 forward ``csrc/flash_fwd_q8.cu`` and
the int8-cache decode ``csrc/flash_decode_q8.cu``), and the fused ring
(``impl="fused"``: on a virtual ring without a key mask one launch of
``csrc/flash_ring_remote.cu`` for the whole ring, the ranks passing KV to
each other inside it; otherwise one launch of ``csrc/flash_ring.cu`` per
ring rank over the all-gathered KV; the backward on the dk/dv and dq
kernels), and packed sequences (``segment_ids=``: per-token document
ids through the forward and backward kernels, locally and on the scan-path
ring), and zig-zag context parallelism (``sequence_parallel="zigzag"``,
``zigzag_attention``: K and V gathered over the ring, each rank's two query
chunks on the forward and backward kernels) and decoding on a mesh
(``prefill``/``decode_step``/``generate`` with a ring-sharded cache, the
ranks' decode-kernel partials merged by ``tree_attn_decode``), and the
model over a mesh of processes (``create_mesh`` over an initialized
process group: each process holds one rank of its row's
``DistributedRing`` and one data row, cut from the same global batch;
``make_train_step(mesh=)`` sums the gradients over the whole mesh; with
``auto_shard=False`` each process passes its own part, ``shard_batch``),
the ring variants (``bidirectional`` half-streams, TokenRing
``counter_rotate``, ``dkv_dtype``) and the ragged-batch helpers, and
the memory knobs (``remat`` with its ``remat_policy`` registry,
``ff_chunk_size``, ``loss_chunk_size``, ``windowed_cache``,
``make_train_step(offload_opt_state=True)``).  Entry points run on the CUDA device unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.  The
package imports torch only.
"""

from .models import FeedForward, RingAttention, RingTransformer, RMSNorm
from .ops import (
    EPSILON,
    MASK_VALUE,
    PAD_SEGMENT_ID,
    FlashCarry,
    FlashPartials,
    QuantizedKV,
    SegmentIds,
    apply_rotary,
    hybrid_positions,
    attend_blocks,
    cuda_flash_attention,
    cuda_flash_decode,
    default_attention,
    dequantize_kv_cache,
    finalize,
    finalize_partials,
    flash_attention,
    flash_backward_blocks,
    flash_bwd,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_bwd_reference,
    flash_decode_q8,
    flash_decode_q8_reference,
    flash_fwd,
    flash_fwd_q8,
    flash_fwd_q8_reference,
    flash_fwd_reference,
    flash_partials,
    flash_partials_q8,
    flash_partials_q8_reference,
    flash_partials_reference,
    fused_ring_local,
    fused_ring_local_plain,
    fused_ring_remote,
    fused_ring_remote_plain,
    init_carry,
    init_partials,
    merge_partials,
    normalize_segment_ids,
    quantize_kv_cache,
    ring_positions,
    rotary_freqs,
    rotate_half,
    segments_overlap,
    softclamp,
)
from .parallel import (
    DistributedRing,
    Mesh,
    Ring,
    VirtualRing,
    create_mesh,
    mesh_all_reduce,
    ring_flash_attention,
    shard_batch,
    tree_attn_decode,
    zigzag_attention,
    zigzag_permute,
    zigzag_positions,
    zigzag_unpermute,
)
from .utils.train import StepStats, init_step_stats, make_train_step
from .weights import export_jax_params, init_random_params, load_jax_params

__all__ = [
    "EPSILON",
    "MASK_VALUE",
    "PAD_SEGMENT_ID",
    "DistributedRing",
    "FeedForward",
    "FlashCarry",
    "FlashPartials",
    "Mesh",
    "QuantizedKV",
    "RMSNorm",
    "Ring",
    "RingAttention",
    "RingTransformer",
    "SegmentIds",
    "StepStats",
    "VirtualRing",
    "apply_rotary",
    "attend_blocks",
    "create_mesh",
    "cuda_flash_attention",
    "cuda_flash_decode",
    "default_attention",
    "dequantize_kv_cache",
    "export_jax_params",
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
    "init_random_params",
    "init_step_stats",
    "load_jax_params",
    "make_train_step",
    "merge_partials",
    "mesh_all_reduce",
    "normalize_segment_ids",
    "quantize_kv_cache",
    "ring_flash_attention",
    "ring_positions",
    "rotary_freqs",
    "rotate_half",
    "segments_overlap",
    "shard_batch",
    "softclamp",
    "tree_attn_decode",
    "zigzag_attention",
    "zigzag_permute",
    "zigzag_positions",
    "zigzag_unpermute",
]
