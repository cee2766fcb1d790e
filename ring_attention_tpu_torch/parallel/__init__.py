"""Sequence parallelism: the ring, its transport, the mesh (its seq and data
rings, the factored mesh's ulysses group, the sum over its processes), the
layouts and the shard cut, zig-zag context parallelism, Ulysses, the
hybrid Ulysses x Ring strategy and tree-attention decoding."""

from .collectives import (
    DistributedRing,
    Ring,
    VirtualRing,
    dequantize_ring_payload,
    quantize_ring_payload,
)
from .hybrid import hybrid_attention
from .mesh import (
    Mesh,
    create_mesh,
    data_world,
    is_factored,
    mesh_all_reduce,
    seq_axes,
    seq_world,
    validate_seq_len,
)
from .ring import ring_flash_attention
from .sharding import (
    cut_rows,
    gather_rows,
    layout_for,
    layout_permute,
    layout_unpermute,
    pad_seq_and_mask,
    pad_to_multiple,
    shard_cut,
    shard_gather,
    stripe_permute,
    stripe_unpermute,
)
from .tree_decode import tree_attn_decode
from .ulysses import kv_head_reshard, ulysses_attention
from .zigzag import (
    GATHERED_KV_BUDGET_BYTES,
    zigzag_attention,
    zigzag_permute,
    zigzag_positions,
    zigzag_unpermute,
)

__all__ = [
    "GATHERED_KV_BUDGET_BYTES",
    "DistributedRing",
    "Mesh",
    "Ring",
    "VirtualRing",
    "create_mesh",
    "cut_rows",
    "data_world",
    "dequantize_ring_payload",
    "gather_rows",
    "hybrid_attention",
    "is_factored",
    "kv_head_reshard",
    "layout_for",
    "layout_permute",
    "layout_unpermute",
    "mesh_all_reduce",
    "pad_seq_and_mask",
    "pad_to_multiple",
    "quantize_ring_payload",
    "ring_flash_attention",
    "seq_axes",
    "seq_world",
    "shard_cut",
    "shard_gather",
    "stripe_permute",
    "stripe_unpermute",
    "tree_attn_decode",
    "ulysses_attention",
    "validate_seq_len",
    "zigzag_attention",
    "zigzag_permute",
    "zigzag_positions",
    "zigzag_unpermute",
]
