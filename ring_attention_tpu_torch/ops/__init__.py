"""Attention ops: the dense oracle, rotary, the blockwise PyTorch flash path,
the partial-state ops, the int8 codec and the host side of the CUDA flash
kernels (forward in its fused, partials and resume modes; dk/dv; dq; the
int8 forward and the int8 decode) and of the fused ring kernels (local
and remote tier)."""

from .attention import (
    EPSILON,
    MASK_VALUE,
    PAD_SEGMENT_ID,
    default_attention,
    softclamp,
)
from .cuda_flash import (
    cuda_flash_attention,
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
    QuantizedKV,
    dequantize_kv_cache,
    flash_decode_q8,
    flash_decode_q8_reference,
    flash_fwd_q8,
    flash_fwd_q8_reference,
    flash_partials_q8,
    flash_partials_q8_reference,
    q8_block,
    quantize_kv_cache,
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
    dequantize_blocks,
    dequantize_rows,
    quantize_blocks,
    quantize_p,
    quantize_rows,
)
from .rotary import apply_rotary, ring_positions, rotary_freqs, rotate_half

__all__ = [
    "EPSILON",
    "INT8_MAX",
    "MASK_VALUE",
    "PAD_SEGMENT_ID",
    "FlashCarry",
    "FlashPartials",
    "QuantizedKV",
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
    "init_carry",
    "init_partials",
    "merge_partials",
    "q8_block",
    "quantize_blocks",
    "quantize_kv_cache",
    "quantize_p",
    "quantize_rows",
    "ring_positions",
    "rotary_freqs",
    "rotate_half",
    "softclamp",
]
