"""Attention ops: the dense oracle, rotary, the blockwise PyTorch flash path
and the CUDA flash-forward kernel's host side."""

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
    flash_fwd,
    flash_fwd_reference,
)
from .flash import FlashCarry, attend_blocks, finalize, flash_attention, init_carry
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
    "flash_fwd",
    "flash_fwd_reference",
    "init_carry",
    "rotary_freqs",
    "rotate_half",
    "softclamp",
]
