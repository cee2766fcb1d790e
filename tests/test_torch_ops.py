"""Parity: the torch port's attention ops vs the JAX package on the CPU.

The same numpy inputs go through ``ring_attention_tpu`` and
``ring_attention_tpu_torch``: the dense oracle, rotary, and the blockwise
flash path over causal, window, key-mask, softclamp, GQA and ``nq != nk``.
Tolerance: float32 on both sides; the two frameworks sum in different
orders, so 2e-5 absolute (the JAX suite's own flash tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ring_attention_tpu.ops as jops
import ring_attention_tpu_torch.ops as tops
from ring_attention_tpu.ops.rotary import apply_rotary as j_apply_rotary
from ring_attention_tpu.ops.rotary import rotary_freqs as j_rotary_freqs

ATOL = 2e-5


def make_inputs(seed, b=2, h=4, hk=2, nq=24, nk=40, d=16):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, nq, d)).astype(np.float32)
    k = r.standard_normal((b, hk, nk, d)).astype(np.float32)
    v = r.standard_normal((b, hk, nk, d)).astype(np.float32)
    mask = r.random((b, nk)) > 0.3
    mask[-1] = False  # one batch row with every key masked
    return q, k, v, mask


CASES = {
    "causal": dict(causal=True),
    "causal_gqa_equal_len": dict(causal=True, nq=40),
    "kv_mask": dict(mask=True),
    "softclamp": dict(causal=True, softclamp_value=2.0),
    "mha": dict(causal=True, hk=4),
    "window": dict(causal=True, window=9),
}


def _call(fn, arrays, case, to):
    q, k, v, mask = (to(a) for a in arrays)
    kw = {key: case[key] for key in ("causal", "softclamp_value", "window")
          if key in case}
    return fn(q, k, v, mask if case.get("mask") else None, **kw)


def _inputs(case, seed=0):
    shape = {key: case[key] for key in ("nq", "hk") if key in case}
    return make_inputs(seed, **shape)


@pytest.mark.parametrize("name", [n for n in CASES if "window" not in CASES[n]])
def test_default_attention_matches_jax(name):
    case = CASES[name]
    arrays = _inputs(case)
    ref = _call(jops.default_attention, arrays, case, jnp.asarray)
    out = _call(tops.default_attention, arrays, case, torch.from_numpy)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("bucket", [None, 16])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_jax(name, bucket):
    """bucket 16 against nk 40 also covers the padded last bucket."""
    case = CASES[name]
    arrays = _inputs(case, seed=1)
    jfn = lambda *a, **kw: jops.flash_attention(*a, bucket_size=bucket, **kw)
    tfn = lambda *a, **kw: tops.flash_attention(*a, bucket_size=bucket, **kw)
    ref = _call(jfn, arrays, case, jnp.asarray)
    out = _call(tfn, arrays, case, torch.from_numpy)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_attend_blocks_carry_matches_jax():
    """The exposed (acc, m, l) carry and its finalize agree, not just out."""
    from ring_attention_tpu.ops import flash as jflash

    from ring_attention_tpu_torch.ops import flash as tflash

    q, k, v, mask = make_inputs(2)
    b, h, nq, d = q.shape
    hk = k.shape[1]
    jc = jflash.attend_blocks(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jflash.init_carry(b, hk, h // hk, nq, d), scale=d**-0.5,
        bucket_size=8, causal_offset=16, window_lo=4, kv_mask=jnp.asarray(mask),
    )
    tc = tflash.attend_blocks(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tflash.init_carry(b, hk, h // hk, nq, d), scale=d**-0.5,
        bucket_size=8, causal_offset=16, window_lo=4,
        kv_mask=torch.from_numpy(mask),
    )
    for j_part, t_part in zip(jflash.finalize(jc), tflash.finalize(tc)):
        np.testing.assert_allclose(t_part.numpy(), np.asarray(j_part), atol=ATOL)


def test_rotary_matches_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 4, 12, 16)).astype(np.float32)
    pos = np.arange(100, 112)
    ref = j_apply_rotary(jnp.asarray(x), j_rotary_freqs(jnp.asarray(pos), 16))
    out = tops.apply_rotary(
        torch.from_numpy(x), tops.rotary_freqs(torch.from_numpy(pos), 16)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_mask_constants_match_jax():
    assert tops.MASK_VALUE == jops.MASK_VALUE
    assert np.isfinite(tops.MASK_VALUE)
    assert tops.EPSILON == 1e-10


def test_validation_messages_match_jax():
    """Same one-line ValueError text as the JAX package for a transposed
    (batch, seq, heads, dim) call."""
    q = np.zeros((1, 16, 4, 8), np.float32)  # (batch, seq, heads, dim)
    k = np.zeros((1, 12, 4, 8), np.float32)
    with pytest.raises(ValueError) as jerr:
        jops.default_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    with pytest.raises(ValueError) as terr:
        tops.default_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k)
        )
    assert str(terr.value) == str(jerr.value)
