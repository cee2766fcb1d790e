"""Parity: the port's int8 codec (``ops/quant.py``) and cache quantization
(``ops/cuda_flash_q8.py``) vs ``ring_attention_tpu.ops.quant`` and
``ring_attention_tpu.ops.pallas_flash`` on the same numpy inputs.

The int8 values must be identical and the f32 scales within one float32
ulp (both sides divide an f32 absmax by 127).  The inputs carry what is
subtle in the codec: an all-zero row (unsafe scale 0 from ``quantize_rows``
and ``quantize_blocks``, safe scale 1 from ``quantize_p``), values that
land exactly on a half step (round half to even on both sides), bf16 and
f32 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.ops import pallas_flash as jpf
from ring_attention_tpu.ops import quant as jquant
from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
from ring_attention_tpu_torch.ops import quant

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, shape=(2, 3, 64, 16)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    x[0, 0, 5] = 0.0  # an all-zero row
    # a row whose absmax is 127: every integer and half-integer below rounds
    # exactly at a half step, where half-to-even and half-away differ
    x[1, 2, 7] = np.concatenate([[127.0], np.arange(x.shape[-1] - 1) + 0.5])
    return x


def _pair(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _assert_scales(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_rows_equals_jax(dtype):
    t, j = _pair(_inputs(0), dtype)
    values, scales = quant.quantize_rows(t)
    ref_values, ref_scales = jquant.quantize_rows(j)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    _assert_scales(scales, ref_scales)
    assert scales[0, 0, 5] == 0.0  # the unsafe scale of an all-zero row
    np.testing.assert_array_equal(  # half steps round to even
        values[1, 2, 7, 1:5].numpy(), np.array([0, 2, 2, 4], dtype=np.int8))
    deq = quant.dequantize_rows(values, scales, torch.float32)
    ref_deq = jquant.dequantize_rows(ref_values, ref_scales, jnp.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(ref_deq), rtol=2e-7, atol=0)


@pytest.mark.parametrize("block", [8, 16, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_blocks_equals_jax(dtype, block):
    x = _inputs(1)
    x[0, 1, :block] = 0.0  # an all-zero block
    t, j = _pair(x, dtype)
    values, scales = quant.quantize_blocks(t, block)
    ref_values, ref_scales = jquant.quantize_blocks(j, block)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    _assert_scales(scales, ref_scales)
    assert scales[0, 1, 0] == 0.0
    deq = quant.dequantize_blocks(values, scales, block, torch.float32)
    ref_deq = jquant.dequantize_blocks(ref_values, ref_scales, block, jnp.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(ref_deq), rtol=2e-7, atol=0)


def test_quantize_blocks_rejects_a_ragged_block():
    with pytest.raises(ValueError, match="must divide"):
        quant.quantize_blocks(torch.zeros((1, 10, 4)), 4)


def test_quantize_p_equals_jax():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((4, 8, 32)).astype(np.float32)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p[1, 3] = 0.0  # a fully masked row: safe scale 1, values 0
    p[2, 0, :4] = p[2, 0].max() * np.array([0.5, 1.5, 2.5, 3.5]) / 127
    p8, safe = quant.quantize_p(torch.from_numpy(p))
    ref_p8, ref_safe = jquant.quantize_p(jnp.asarray(p))
    np.testing.assert_array_equal(p8.numpy(), np.asarray(ref_p8))
    _assert_scales(safe, ref_safe)
    assert safe[1, 3, 0] == 1.0 and int(p8[1, 3].abs().max()) == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kv_cache_codec_equals_jax(dtype):
    k, jk = _pair(_inputs(3), dtype)
    v, jv = _pair(_inputs(4), dtype)
    kv = q8.quantize_kv_cache(k, v)
    ref = jpf.quantize_kv_cache(jk, jv)
    for got, want in zip(kv, ref):
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _assert_scales(got, want)
    tdt, jdt = DTYPES[dtype]
    k_deq, v_deq = q8.dequantize_kv_cache(kv, tdt)
    ref_k, ref_v = jpf.dequantize_kv_cache(ref, jdt)
    for got, want in ((k_deq, ref_k), (v_deq, ref_v)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2e-7 if dtype == "f32" else 0, atol=0)
