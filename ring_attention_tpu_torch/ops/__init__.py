"""Attention ops: the dense oracle, rotary, the blockwise PyTorch flash path,
the partial-state ops and the host side of the CUDA flash kernels (forward
in its fused, partials and resume modes; dk/dv; dq)."""

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
from .flash import (
    FlashCarry,
    attend_blocks,
    finalize,
    flash_attention,
    flash_backward_blocks,
    init_carry,
)
from .partials import FlashPartials, finalize_partials, init_partials, merge_partials
from .rotary import apply_rotary, ring_positions, rotary_freqs, rotate_half

__all__ = [
    "EPSILON",
    "MASK_VALUE",
    "PAD_SEGMENT_ID",
    "FlashCarry",
    "FlashPartials",
    "apply_rotary",
    "attend_blocks",
    "cuda_flash_attention",
    "cuda_flash_decode",
    "default_attention",
    "finalize",
    "finalize_partials",
    "flash_attention",
    "flash_backward_blocks",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_reference",
    "flash_fwd",
    "flash_fwd_reference",
    "flash_partials",
    "flash_partials_reference",
    "init_carry",
    "init_partials",
    "merge_partials",
    "ring_positions",
    "rotary_freqs",
    "rotate_half",
    "softclamp",
]
