"""Sequence parallelism: the ring, its transport, the mesh and the layouts."""

from .collectives import DistributedRing, Ring, VirtualRing
from .mesh import Mesh, create_mesh, data_world, seq_world, validate_seq_len
from .ring import ring_flash_attention
from .sharding import (
    layout_for,
    layout_permute,
    layout_unpermute,
    pad_seq_and_mask,
    pad_to_multiple,
    stripe_permute,
    stripe_unpermute,
)

__all__ = [
    "DistributedRing",
    "Mesh",
    "Ring",
    "VirtualRing",
    "create_mesh",
    "data_world",
    "layout_for",
    "layout_permute",
    "layout_unpermute",
    "pad_seq_and_mask",
    "pad_to_multiple",
    "ring_flash_attention",
    "seq_world",
    "stripe_permute",
    "stripe_unpermute",
    "validate_seq_len",
]
