"""Parity pins: model cases of the ring and of decoding that no other port
test covers, held to the JAX package on the CPU.

- The ring models (``create_mesh(ring_size=4)`` in the port, the JAX model
  on its (data 2, ring 4) mesh of the 8 virtual CPU devices, the JAX
  weights through ``load_jax_params``, an odd sequence of 127): the
  striped ring with lookback windows ``(12, None)`` and ``(40, 70)``, an
  MQA ring (``kv_heads=1``) with lookback ``(33, 5)`` and a non-causal
  striped ring, on ``impl="torch"``, ``"cuda"`` and ``"fused"`` (the kernel
  wrappers run their plain versions on CPU tensors).  Logits to ``ATOL =
  2e-5`` against the JAX ``impl="xla"`` model.
- Decoding past the cache length: a window-sized ring-buffer cache (8
  slots, every layer looking back 8 tokens), a 12-token prompt and ten
  teacher-forced decode steps that wrap the buffer, with and without
  ``quantize_cache``, on ``impl="torch"`` and ``"cuda"``; logits to
  ``test_torch_model.py``'s ``1e-4``.  A prompt longer than a cache that
  does not cover the window raises ``ValueError`` on both sides.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu_torch import RingTransformer, load_jax_params
from ring_attention_tpu_torch.parallel import create_mesh

ATOL = 2e-5
LOGITS_ATOL = 1e-4

RING_CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2,
                   dim_head=16, causal=True, bucket_size=16)
RING_VARIANTS = {
    "striped_lookback_12_none": dict(striped=True, max_lookback_seq_len=(12, None)),
    "striped_lookback_40_70": dict(striped=True, max_lookback_seq_len=(40, 70)),
    "mqa_lookback_33_5": dict(kv_heads=1, max_lookback_seq_len=(33, 5)),
    "noncausal_striped": dict(striped=True, causal=False),
}


def _tokens(seed, b=2, n=127):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_ring_model(variant):
    """The JAX ring model's weights and logits, shared by the port impls."""
    jm = JaxTransformer(**dict(RING_CONFIG, **RING_VARIANTS[variant]),
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0, n=128)))
    logits = jm.apply(params, jnp.asarray(_tokens(1)))
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(logits)


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
@pytest.mark.parametrize("variant", list(RING_VARIANTS))
def test_ring_model_case_matches_jax(variant, impl):
    params, ref = _jax_ring_model(variant)
    tm = RingTransformer(**dict(RING_CONFIG, **RING_VARIANTS[variant]), impl=impl,
                         device="cpu", mesh=create_mesh(ring_size=4))
    load_jax_params(tm, params)
    with torch.no_grad():
        logits = tm(torch.from_numpy(_tokens(1)))
    np.testing.assert_allclose(logits.numpy(), ref, atol=ATOL, rtol=0)


DECODE_CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2,
                     dim_head=16, causal=True, max_lookback_seq_len=8)
CACHE_SLOTS = 8
PROMPT, STEPS = 12, 10


@functools.cache
def _jax_decode(quantize_cache):
    """Prefill logits, then each teacher-forced decode step's logits, of the
    JAX model on a window-sized cache."""
    jm = JaxTransformer(**DECODE_CONFIG, quantize_cache=quantize_cache)
    tokens = _tokens(2, n=PROMPT + STEPS)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    cache = jm.apply(params, 2, CACHE_SLOTS, method=jm.init_cache)
    logits, cache = jax.jit(partial(jm.apply, method=jm.prefill))(
        params, jnp.asarray(tokens[:, :PROMPT]), cache)
    steps = [np.asarray(logits)]
    decode = jax.jit(partial(jm.apply, method=jm.decode_step))
    for pos in range(PROMPT, PROMPT + STEPS):
        logits, cache = decode(params, jnp.asarray(tokens[:, pos]), cache, jnp.int32(pos))
        steps.append(np.asarray(logits))
    return jax.tree_util.tree_map(np.asarray, params), tokens, steps


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("quantize_cache", [False, True], ids=["float_cache", "int8_cache"])
def test_decode_past_the_cache_length_matches_jax(quantize_cache, impl):
    params, tokens, ref = _jax_decode(quantize_cache)
    tm = RingTransformer(**DECODE_CONFIG, quantize_cache=quantize_cache, impl=impl,
                         device="cpu")
    load_jax_params(tm, params)
    with torch.no_grad():
        cache = tm.init_cache(2, CACHE_SLOTS)
        logits, cache = tm.prefill(torch.from_numpy(tokens[:, :PROMPT]), cache)
        got = [logits.numpy()]
        for pos in range(PROMPT, PROMPT + STEPS):
            logits, cache = tm.decode_step(torch.from_numpy(tokens[:, pos]), cache, pos)
            got.append(logits.numpy())
    for step, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, atol=LOGITS_ATOL, rtol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("quantize_cache", [False, True], ids=["float_cache", "int8_cache"])
def test_prompt_longer_than_a_short_cache_raises(quantize_cache):
    """A cache of 6 slots cannot hold the 8-token window: both packages
    refuse a 12-token prompt."""
    params, tokens, _ = _jax_decode(quantize_cache)
    jm = JaxTransformer(**DECODE_CONFIG, quantize_cache=quantize_cache)
    prompt = tokens[:, :PROMPT]
    with pytest.raises(ValueError, match="longer than the cache"):
        jm.apply(params, jnp.asarray(prompt), jm.apply(params, 2, 6, method=jm.init_cache),
                 method=jm.prefill)
    tm = RingTransformer(**DECODE_CONFIG, quantize_cache=quantize_cache, device="cpu")
    load_jax_params(tm, params)
    with pytest.raises(ValueError, match="longer than the cache"):
        tm.prefill(torch.from_numpy(prompt), tm.init_cache(2, 6))
