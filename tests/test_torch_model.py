"""Parity: the torch port's RingTransformer vs the JAX one on the CPU.

Weights come from the JAX ``RingTransformer.init`` and are carried over
with ``load_jax_params``; the same numpy tokens go through both models.
``impl="cuda"`` (whose kernel wrapper runs its plain version on CPU
tensors) is held to ``use_pallas=True`` (the Pallas kernels in interpret
mode), ``impl="torch"`` to ``use_pallas=False``.  Covered: logits and the
loss, a layer with a lookback window, softclamp, prefill followed by
teacher-forced decode steps, and greedy ``generate``.
Tolerance: float32 on both sides through two layers and a 256-way
projection, 1e-4 absolute on logits and 1e-5 relative on
the loss.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu_torch import RingTransformer, load_jax_params

LOGITS_ATOL = 1e-4
CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2,
              dim_head=16, causal=True)
VARIANTS = {
    "plain": {},
    # layer 0 looks back 8 tokens, layer 1 attends globally; both softclamp
    "lookback_softclamp": dict(max_lookback_seq_len=(8, None), softclamp_value=4.0),
}
IMPLS = {"cuda": True, "torch": False}  # port impl -> JAX use_pallas


def _tokens(seed, b=2, n=33):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _pair(variant, impl):
    kw = dict(CONFIG, **VARIANTS[variant])
    jm = JaxTransformer(**kw, use_pallas=IMPLS[impl])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    tm = RingTransformer(**kw, impl=impl, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_and_loss_match_jax(variant, impl):
    jm, params, tm = _pair(variant, impl)
    tokens = _tokens(1)
    ref_logits = jm.apply(params, jnp.asarray(tokens))
    tokens[0, -1] = -1  # a label-only position: ignore_index drops it
    example_mask = np.array([True, variant == "plain"])
    ref_loss = jm.apply(params, jnp.asarray(tokens), return_loss=True,
                        example_mask=jnp.asarray(example_mask))
    with torch.no_grad():
        logits = tm(torch.from_numpy(_tokens(1)))
        loss = tm(torch.from_numpy(tokens), return_loss=True,
                  example_mask=torch.from_numpy(example_mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_prefill_then_decode_steps_match_jax(impl):
    """Teacher forcing: after a prefill of 12 tokens, each decode step gets
    the same next token on both sides and the logits are compared."""
    jm, params, tm = _pair("lookback_softclamp", impl)
    tokens = _tokens(2, n=16)
    prompt, rest = tokens[:, :12], tokens[:, 12:]
    max_len = 24

    jcache = jm.apply(params, 2, max_len, method=jm.init_cache)
    jlogits, jcache = jax.jit(partial(jm.apply, method=jm.prefill))(
        params, jnp.asarray(prompt), jcache
    )
    jdecode = jax.jit(partial(jm.apply, method=jm.decode_step))
    with torch.no_grad():
        cache = tm.init_cache(2, max_len)
        logits, cache = tm.prefill(torch.from_numpy(prompt), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGITS_ATOL, rtol=0)
        for i in range(rest.shape[1]):
            pos = prompt.shape[1] + i
            jlogits, jcache = jdecode(
                params, jnp.asarray(rest[:, i]), jcache, jnp.int32(pos)
            )
            logits, cache = tm.decode_step(torch.from_numpy(rest[:, i]), cache, pos)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=LOGITS_ATOL, rtol=0)
    for layer in range(CONFIG["depth"]):
        np.testing.assert_allclose(cache["k"][layer].numpy(),
                                   np.asarray(jcache["k"][layer]), atol=1e-5)


def test_greedy_generate_matches_jax():
    jm, params, tm = _pair("plain", "cuda")
    prompt = _tokens(3, n=10)
    ref = jm.apply(params, jnp.asarray(prompt), 24, 8, method=jm.generate)
    out = tm.generate(torch.from_numpy(prompt), 24, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampling_is_seeded_and_respects_top_k():
    _, _, tm = _pair("plain", "cuda")
    prompt = torch.from_numpy(_tokens(4, n=6))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tm.generate(prompt, 16, 8, temperature=0.8, top_k=1,
                           generator=gen)

    # top_k=1 leaves one token: sampling equals greedy whatever the seed
    np.testing.assert_array_equal(draw(0).numpy(), tm.generate(prompt, 16, 8).numpy())
    gen_a = torch.Generator().manual_seed(5)
    gen_b = torch.Generator().manual_seed(5)
    a = tm.generate(prompt, 16, 8, temperature=1.0, top_p=0.9, generator=gen_a)
    b = tm.generate(prompt, 16, 8, temperature=1.0, top_p=0.9, generator=gen_b)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
