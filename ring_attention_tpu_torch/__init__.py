"""ring_attention_tpu_torch: the PyTorch/CUDA port of ring_attention_tpu.

This slice ports the single-device serving path of ``RingTransformer``
(forward logits, ``prefill``, KV-cache ``decode_step``, ``generate``) onto a
hand-written CUDA flash-forward kernel for Hopper (``csrc/flash_fwd.cu``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.  The package imports torch only.
"""

from .models import FeedForward, RingAttention, RingTransformer, RMSNorm
from .ops import (
    EPSILON,
    MASK_VALUE,
    PAD_SEGMENT_ID,
    FlashCarry,
    apply_rotary,
    attend_blocks,
    cuda_flash_attention,
    cuda_flash_decode,
    default_attention,
    finalize,
    flash_attention,
    flash_fwd,
    flash_fwd_reference,
    init_carry,
    rotary_freqs,
    rotate_half,
    softclamp,
)
from .weights import init_random_params, load_jax_params

__all__ = [
    "EPSILON",
    "MASK_VALUE",
    "PAD_SEGMENT_ID",
    "FeedForward",
    "FlashCarry",
    "RMSNorm",
    "RingAttention",
    "RingTransformer",
    "apply_rotary",
    "attend_blocks",
    "cuda_flash_attention",
    "cuda_flash_decode",
    "default_attention",
    "finalize",
    "flash_attention",
    "flash_fwd",
    "flash_fwd_reference",
    "init_carry",
    "init_random_params",
    "load_jax_params",
    "rotary_freqs",
    "rotate_half",
    "softclamp",
]
