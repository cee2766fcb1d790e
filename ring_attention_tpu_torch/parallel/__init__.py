"""Sequence parallelism: the ring (and its variants), its transport, the
ragged-batch helpers, the mesh (its seq and data rings, the factored
mesh's ulysses group, the sum over its processes, a process's part of a
batch), the layouts and the shard cut, zig-zag context parallelism,
Ulysses, the hybrid Ulysses x Ring strategy and tree-attention decoding."""

from .collectives import (
    DistributedRing,
    Ring,
    VirtualRing,
    all_gather_variable,
    compact_masked,
    dequantize_ring_payload,
    fold_batch_into_seq,
    gather_sizes,
    quantize_ring_payload,
    split_by_rank,
    unfold_seq_into_batch,
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
    shard_batch,
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
    "all_gather_variable",
    "compact_masked",
    "create_mesh",
    "cut_rows",
    "data_world",
    "dequantize_ring_payload",
    "fold_batch_into_seq",
    "gather_rows",
    "gather_sizes",
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
    "shard_batch",
    "shard_cut",
    "shard_gather",
    "split_by_rank",
    "stripe_permute",
    "stripe_unpermute",
    "tree_attn_decode",
    "ulysses_attention",
    "unfold_seq_into_batch",
    "validate_seq_len",
    "zigzag_attention",
    "zigzag_permute",
    "zigzag_positions",
    "zigzag_unpermute",
]
