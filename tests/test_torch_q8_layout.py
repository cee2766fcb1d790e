"""The int8 kernels' host-side layouts, on the CPU (no JAX).

- ``v_block_layout``: the V^T that ``csrc/flash_fwd_q8.cu`` reads, per
  quantization block of ``block`` keys, zero-padded to whole 64-key tiles,
  each 32-key chunk's keys in the order of the P V product's register
  operand.  Read back through the fragment order (written out here from
  the wgmma layouts, not taken from the module), un-permuted and
  un-padded, it gives ``quantize_blocks``' v8 exactly.
- The int8 decode's split choice (``decode_splits`` with
  ``decode_split_size``, as ``csrc/flash_decode_q8.cu`` cuts its ranges)
  covers every key exactly once, with no empty range, for every key count
  from 1 to 1,048,576.
"""

import numpy as np
import pytest
import torch

from ring_attention_tpu_torch.ops import cuda_flash as cf
from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
from ring_attention_tpu_torch.ops.quant import quantize_blocks


def _fragment_keys() -> list[int]:
    """Key (0..31) of each contraction index of a 32-key chunk: the score
    accumulator leaves thread t of a quad keys 8j + 2t and 8j + 2t + 1 of
    n-tiles j = 0..3; the A operand's register 0 takes indices 4t..4t+3 as
    the n-tile 0 and 1 pairs, register 2 indices 16 + 4t.. as n-tiles 2, 3."""
    keys = [0] * 32
    for t in range(4):
        for i, (j, e) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            keys[4 * t + i] = 8 * j + 2 * t + e
            keys[16 + 4 * t + i] = 8 * (j + 2) + 2 * t + e
    return keys


@pytest.mark.parametrize("nk, block_k", [
    (2048, 64), (960, 96), (4096, 1024), (4096, 2048),
    (1000, None),  # one block of 1,000 keys, not a multiple of 64
    (1100, None),  # q8_block(1100) = 4: blocks below one tile
    (200, 8),
])
def test_v_block_layout_inverts_to_quantize_blocks(nk, block_k):
    gen = torch.Generator().manual_seed(nk)
    v = torch.randn((1, 2, nk, 64), generator=gen)
    block = q8.q8_block(nk, block_k)
    v8, _ = quantize_blocks(v, block)
    vt = q8.v_block_layout(v8, block)
    padded = -(-block // 64) * 64
    assert vt.dtype == torch.int8 and vt.is_contiguous()
    assert tuple(vt.shape) == (1, 2, nk // block, 64, padded)
    assert q8.pv_chunk_keys().tolist() == _fragment_keys()
    keys = np.arange(padded) // 32 * 32 + np.array(_fragment_keys())[np.arange(padded) % 32]
    real = keys < block
    assert (vt[..., ~torch.from_numpy(real)] == 0).all()  # the padding is zero
    back = torch.empty((1, 2, nk // block, block, 64), dtype=torch.int8)
    back[:, :, :, torch.from_numpy(keys[real])] = vt[..., torch.from_numpy(real)].transpose(-1, -2)
    assert torch.equal(back.reshape(v8.shape), v8)


@pytest.mark.parametrize("heads, groups", [(8, 1), (32, 1), (1, 3)])
def test_decode_q8_splits_cover_every_key_once(heads, groups):
    sms = 132
    nk = np.arange(1, (1 << 20) + 1, dtype=np.int64)
    # the int8 decode's choice: decode_splits at twice the SM count
    splits = cf.decode_splits(heads, groups, nk, 2 * sms)
    per = cf.decode_split_size(nk, splits)
    assert (splits >= 1).all() and (splits <= 65535).all()
    assert (per % 64 == 0).all()  # whole 64-key tiles
    # ranges [min(nk, i per), min(nk, i per + per)) for i < splits: disjoint
    # and in order, so every key is in one when the last one reaches nk,
    # and none is empty when the last one starts before nk
    assert (splits * per >= nk).all()
    assert ((splits - 1) * per < nk).all()
    for n in (1, 63, 64, 65, 4095, 32768, 1 << 20):  # the scalar form agrees
        s = cf.decode_splits(heads, groups, n, 2 * sms)
        assert isinstance(s, int) and s == splits[n - 1]


def test_decode_q8_rows():
    assert [q8.decode_q8_rows(r) for r in (1, 2, 3, 4, 5, 8, 9, 16, 17, 64)] == [
        1, 2, 4, 4, 8, 8, 16, 16, 16, 16]
