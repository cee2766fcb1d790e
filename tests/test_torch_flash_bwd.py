"""Parity: the backward of the port's flash attention vs the JAX package's.

On CPU tensors ``flash_bwd`` (and through it the gradient of
``cuda_flash_attention``) runs the kernels' plain version,
``flash_bwd_reference``; the JAX side runs the TPU kernels themselves,
``pallas_flash_backward``, in the Pallas interpreter, as the JAX suite's
own tests do.  The blockwise path's ``flash_backward_blocks`` and the
custom gradient of ``ops/flash.py::flash_attention`` are held to their JAX
counterparts.  Cases: causal, offset ``nq < nk``, window, softclamp, a key
mask with an all-False row, GQA ``hk < h``, and causal ``nq > nk`` (rows
with no key in their band); and the bf16 dq kernel's block edges (ragged
128-row blocks, band edges inside a block, a key mask that leaves one
64-row half of a block no key).
Tolerance: float32 on both sides, 5e-5 absolute on gradients up to ~20
in size (sums over up to 128 keys or 128 rows in another order; the
largest error seen is 1.5e-5); the all-False row's lse is
``MASK_VALUE + log(nk)`` on both sides.

The kernels themselves (CUDA tensors) are held to the same plain version
on the GPU by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.ops import default_attention as jax_default_attention
from ring_attention_tpu.ops.flash import flash_attention as jax_flash_attention
from ring_attention_tpu.ops.flash import flash_backward_blocks as jax_backward_blocks
from ring_attention_tpu.ops.pallas_flash import (
    pallas_flash_attention,
    pallas_flash_backward,
    pallas_flash_fused,
)
from ring_attention_tpu_torch.ops import cuda_flash
from ring_attention_tpu_torch.ops.flash import flash_attention, flash_backward_blocks

ATOL = 5e-5


def make_inputs(seed, b=2, h=4, hk=2, nq=64, nk=128, d=32):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, nq, d)).astype(np.float32)
    k = r.standard_normal((b, hk, nk, d)).astype(np.float32)
    v = r.standard_normal((b, hk, nk, d)).astype(np.float32)
    do = r.standard_normal((b, h, nq, d)).astype(np.float32)
    mask = r.random((b, nk)) > 0.4
    mask[-1] = False  # one batch row with every key masked
    return q, k, v, do, mask


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol, rtol=0)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (offset, window_lo, softclamp, kv_mask, nq, h, hk[, nk]): offset None =
# non-causal, nk 128 unless given; kv_mask "half" masks keys 0..63, which
# leaves causal rows 0..63 (one 64-row half of the dq kernel's first
# 128-row block) no key
SWEEPS = {
    "causal": (0, None, None, False, 128, 4, 2),
    "causal_offset": (64, None, None, False, 64, 4, 2),
    "window": (0, -23, None, False, 128, 4, 2),
    "softclamp": (0, None, 3.0, False, 128, 4, 2),
    "kv_mask_all_false_row": (None, None, None, True, 64, 4, 2),
    "gqa_h8_hk1": (0, None, None, False, 128, 8, 1),
    # the bf16 dq kernel's 128-row blocks and 64-key tiles: ragged last
    # blocks, band edges inside a block and inside a tile
    "ragged_nq129": (0, None, None, False, 129, 2, 1, 129),
    "ragged_nq192_offset": (64, None, None, False, 192, 2, 1, 256),
    "ragged_nq255_window_softclamp": (0, -70, 3.0, False, 255, 2, 1, 255),
    "causal_edge_mid_block": (96, None, None, False, 256, 2, 1, 352),
    "window_edge_mid_block": (0, -100, None, False, 256, 2, 1, 256),
    "kv_mask_empties_half_block": (0, None, None, "half", 128, 2, 1, 128),
}


@functools.cache
def _sweep(name):
    """The inputs of a sweep, lse and delta from the Pallas forward, and
    the Pallas backward kernels' (dq, dk, dv), computed once."""
    offset, lo, clamp, masked, nq, h, hk, *nk = SWEEPS[name]
    q, k, v, do, mask = make_inputs(0, h=h, hk=hk, nq=nq, nk=nk[0] if nk else 128)
    if masked == "half":
        mask = np.ones_like(mask)
        mask[:, :64] = False
    kw = dict(scale=q.shape[-1] ** -0.5, causal_offset=offset, window_lo=lo,
              softclamp_value=clamp)
    jmask = jnp.asarray(mask) if masked else None
    out, lse = pallas_flash_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jmask, interpret=True, **kw)
    delta = (do * np.asarray(out)).sum(-1)
    ref = pallas_flash_backward(
        jnp.asarray(do), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lse,
        jnp.asarray(delta), jmask, interpret=True, **kw,
    )
    return ((do, q, k, v, np.asarray(lse), delta), mask if masked else None, kw,
            tuple(np.asarray(r) for r in ref))


@pytest.mark.parametrize("name", list(SWEEPS))
def test_flash_bwd_reference_matches_pallas(name):
    """The kernels' plain version against both TPU backward kernels on the
    same (do, q, k, v, lse, delta); lse comes from the TPU forward."""
    inputs, mask, kw, ref = _sweep(name)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = cuda_flash.flash_bwd(*_t(*inputs), tmask, **kw)
    for x, r in zip(got, ref):
        _close(x, r)
    # the per-kernel wrappers give the same gradients on the CPU
    dk, dv = cuda_flash.flash_bwd_dkv(*_t(*inputs), tmask, **kw)
    np.testing.assert_array_equal(dk.numpy(), got[1].numpy())
    np.testing.assert_array_equal(dv.numpy(), got[2].numpy())


# (causal, window, softclamp, masked, nq, nk, h, hk)
GRAD_CASES = {
    "causal": (True, None, None, False, 128, 128, 4, 2),
    "causal_offset_nq_lt_nk": (True, None, None, False, 64, 128, 4, 2),
    "window": (True, 40, None, False, 128, 128, 4, 2),
    "softclamp": (True, None, 3.0, False, 128, 128, 4, 2),
    "kv_mask_all_false_row": (False, None, None, True, 64, 128, 4, 2),
    "gqa_h8_hk1": (True, None, None, False, 128, 128, 8, 1),
}


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(do))


def _torch_grads(fn, q, k, v, do):
    q, k, v = (x.requires_grad_() for x in _t(q, k, v))
    out = fn(q, k, v)
    return torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_cuda_flash_attention_grad_matches_pallas(name):
    causal, window, clamp, masked, nq, nk, h, hk = GRAD_CASES[name]
    q, k, v, do, mask = make_inputs(1, h=h, hk=hk, nq=nq, nk=nk)
    kw = dict(causal=causal, window=window, softclamp_value=clamp)
    ref = _jax_grads(
        lambda q, k, v: pallas_flash_attention(
            q, k, v, jnp.asarray(mask) if masked else None, interpret=True, **kw
        ), q, k, v, do,
    )
    got = _torch_grads(
        lambda q, k, v: cuda_flash.cuda_flash_attention(
            q, k, v, torch.from_numpy(mask) if masked else None, **kw
        ), q, k, v, do,
    )
    for x, r in zip(got, ref):
        _close(x, r)


@pytest.mark.parametrize("name", ["causal", "window", "softclamp",
                                  "kv_mask_all_false_row", "gqa_h8_hk1"])
def test_flash_backward_blocks_matches_jax(name):
    """The blockwise backward over one KV span, bucket by bucket, on the
    same (do, q, k, v, lse, delta) in the grouped ``(b, hk, g, nq)`` layout."""
    offset, lo, clamp, masked, nq, h, hk = SWEEPS[name]
    q, k, v, do, mask = make_inputs(2, h=h, hk=hk, nq=nq)
    b, _, _, d = q.shape
    kw = dict(scale=d ** -0.5, bucket_size=32, causal_offset=offset,
              window_lo=lo, softclamp_value=clamp)
    r = np.random.default_rng(3)
    lse = (r.standard_normal((b, hk, h // hk, nq)) + 5.0).astype(np.float32)
    delta = r.standard_normal((b, hk, h // hk, nq)).astype(np.float32)
    ref = jax_backward_blocks(
        *(jnp.asarray(x) for x in (do, q, k, v, lse, delta)),
        kv_mask=jnp.asarray(mask) if masked else None, **kw,
    )
    got = flash_backward_blocks(
        *_t(do, q, k, v, lse, delta),
        kv_mask=torch.from_numpy(mask) if masked else None, **kw,
    )
    for x, rr in zip(got, ref):
        _close(x, rr)


@pytest.mark.parametrize("name", ["causal", "window", "softclamp",
                                  "kv_mask_all_false_row", "gqa_h8_hk1"])
def test_flash_attention_grad_matches_jax(name):
    """The custom gradient of ``ops/flash.py::flash_attention`` against
    ``jax.grad`` of the JAX ``flash_attention`` (its custom_vjp), with a
    bucket that does not divide nk (padded keys)."""
    causal, window, clamp, masked, nq, _, h, hk = GRAD_CASES[name]
    q, k, v, do, mask = make_inputs(4, h=h, hk=hk, nq=nq, nk=120)
    kw = dict(causal=causal, window=window, softclamp_value=clamp, bucket_size=32)
    ref = _jax_grads(
        lambda q, k, v: jax_flash_attention(
            q, k, v, jnp.asarray(mask[:, :120]) if masked else None, **kw
        ), q, k, v, do,
    )
    got = _torch_grads(
        lambda q, k, v: flash_attention(
            q, k, v, torch.from_numpy(mask[:, :120]) if masked else None, **kw
        ), q, k, v, do,
    )
    for x, r in zip(got, ref):
        _close(x, r)


def test_forward_keeps_lse_for_an_all_masked_row():
    """The forward saves its lse; the backward recomputes p from it with a
    select, so a batch row whose keys are all masked (lse ~ MASK_VALUE,
    exp(s - lse) = inf) gives finite gradients: zero dq for its queries and
    zero dk/dv for its keys, on both the CUDA path and the blockwise path."""
    q, k, v, do, mask = make_inputs(5)
    for fn in (cuda_flash.cuda_flash_attention,
               lambda q, k, v, m: flash_attention(q, k, v, m, bucket_size=32)):
        dq, dk, dv = _torch_grads(lambda q, k, v: fn(q, k, v, torch.from_numpy(mask)),
                                  q, k, v, do)
        for g in (dq, dk, dv):
            assert bool(torch.isfinite(g).all())
        assert not dq[-1].any() and not dk[-1].any() and not dv[-1].any()
        assert dq[0].abs().max() > 0 and dv[0].abs().max() > 0


def test_band_empty_rows_follow_the_jax_flash_backward():
    """Causal with nq > nk leaves the first nq - nk query rows with no key
    in their band.  Their forward averages V over every key (the oracle's
    value), but the flash backward, in the JAX package and in the port,
    gives them zero dq and no dk/dv contribution; autograd through the
    dense oracle instead sends each key do / nk of such a row in dv."""
    q, k, v, do, _ = make_inputs(6, nq=96, nk=48)
    ref = _jax_grads(
        lambda q, k, v: pallas_flash_attention(q, k, v, causal=True, interpret=True),
        q, k, v, do,
    )
    got = _torch_grads(
        lambda q, k, v: cuda_flash.cuda_flash_attention(q, k, v, causal=True),
        q, k, v, do,
    )
    for x, r in zip(got, ref):
        _close(x, r)
    assert not got[0][:, :, :48].any()
    oracle = _jax_grads(
        lambda q, k, v: jax_default_attention(q, k, v, causal=True), q, k, v, do
    )
    _close(got[0], oracle[0])  # dq: zero there either way
    _close(got[1], oracle[1])
    # dv differs by exactly the band-empty rows' uniform average
    g = q.shape[1] // k.shape[1]
    extra = do[:, :, :48].reshape(2, 2, g, 48, -1).sum(axis=(2, 3)) / 48
    _close(np.asarray(oracle[2]) - got[2].numpy(),
           np.broadcast_to(extra[:, :, None], got[2].shape))
