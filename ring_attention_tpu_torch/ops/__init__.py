"""Attention ops: the dense oracle, rotary, the blockwise PyTorch flash path
and the host side of the CUDA flash kernels (forward, dk/dv, dq)."""

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
)
from .flash import (
    FlashCarry,
    attend_blocks,
    finalize,
    flash_attention,
    flash_backward_blocks,
    init_carry,
)
from .rotary import apply_rotary, rotary_freqs, rotate_half

__all__ = [
    "EPSILON",
    "MASK_VALUE",
    "PAD_SEGMENT_ID",
    "FlashCarry",
    "apply_rotary",
    "attend_blocks",
    "cuda_flash_attention",
    "cuda_flash_decode",
    "default_attention",
    "finalize",
    "flash_attention",
    "flash_backward_blocks",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_reference",
    "flash_fwd",
    "flash_fwd_reference",
    "init_carry",
    "rotary_freqs",
    "rotate_half",
    "softclamp",
]
