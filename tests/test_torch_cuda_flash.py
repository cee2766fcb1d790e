"""Parity: the CUDA flash kernel's wrappers, on CPU tensors, vs the Pallas
forward kernel run in interpret mode (the backward's parity is in
``test_torch_flash_bwd.py``).

On the CPU ``flash_fwd`` (and through it ``cuda_flash_attention``) and
``cuda_flash_decode`` run their kernels' plain versions; the JAX side runs
the TPU kernel itself, ``_flash_fwd_call(fused=True)``, in the Pallas
interpreter, as the JAX suite's own tests do.  Out and lse are both held,
including a key mask with an all-False row and folded-row decode, and at
the bf16 kernel's block edges (ragged 128-row blocks, band edges inside a
block, a key mask that leaves one 64-row half of a block no live key).
Tolerance: float32 on both sides, 2e-5 absolute (summation order); the
lse of an all-masked row is ``MASK_VALUE + log(nk)``, which rounds to
``MASK_VALUE`` in float32 on both sides.

The kernel itself (CUDA tensors) is held to the same plain version on the
GPU by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.ops.pallas_flash import (
    pallas_flash_attention,
    pallas_flash_decode,
    pallas_flash_fused,
)
from ring_attention_tpu_torch.ops import cuda_flash

ATOL = 2e-5


def make_inputs(seed, b=2, h=4, hk=2, nq=64, nk=128, d=32):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, nq, d)).astype(np.float32)
    k = r.standard_normal((b, hk, nk, d)).astype(np.float32)
    v = r.standard_normal((b, hk, nk, d)).astype(np.float32)
    mask = r.random((b, nk)) > 0.4
    mask[-1] = False  # one batch row with every key masked
    return q, k, v, mask


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def half_block_mask(b, nk):
    """A key mask that leaves causal rows 0..63 (the first 64-row half of
    the kernel's first 128-row block) no live key in their band while rows
    64..127 keep theirs: keys 0..63 masked, the rest kept."""
    mask = np.ones((b, nk), dtype=bool)
    mask[:, :64] = False
    return mask


# (offset, window_lo, softclamp, kv_mask, nq[, nk]): offset None = non-causal,
# nk 128 unless given; kv_mask "half" is half_block_mask
SWEEPS = {
    "causal": (0, None, None, False, 128),
    "causal_offset": (64, None, None, False, 64),
    "window": (0, -23, None, False, 128),
    "softclamp": (0, None, 3.0, False, 128),
    "kv_mask_all_false_row": (None, None, None, True, 64),
    # the bf16 kernel's 128-row blocks of two 64-row halves and its 64-key
    # tiles: ragged last blocks, band edges inside a block and inside a
    # tile, and a key mask that empties one half of a block
    "ragged_nq129": (0, None, None, False, 129, 129),
    "ragged_nq192_offset": (64, None, None, False, 192, 256),
    "ragged_nq255_window_softclamp": (0, -70, 3.0, False, 255, 255),
    "causal_edge_mid_block": (96, None, None, False, 256, 352),
    "window_edge_mid_block": (0, -100, None, False, 256, 256),
    "kv_mask_empties_half_block": (0, None, None, "half", 128, 128),
}


@functools.cache
def _sweep(name):
    """The inputs of a sweep and the Pallas kernel's (out, lse) on them,
    computed once."""
    offset, lo, clamp, masked, nq, *nk = SWEEPS[name]
    q, k, v, mask = make_inputs(0, nq=nq, nk=nk[0] if nk else 128)
    if masked == "half":
        mask = half_block_mask(q.shape[0], k.shape[2])
    kw = dict(scale=q.shape[-1] ** -0.5, causal_offset=offset, window_lo=lo,
              softclamp_value=clamp)
    ref_out, ref_lse = pallas_flash_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask) if masked else None, interpret=True, **kw,
    )
    return (q, k, v, mask if masked else None, kw, np.asarray(ref_out),
            np.asarray(ref_lse))


@pytest.mark.parametrize("name", list(SWEEPS))
def test_flash_fwd_out_and_lse_match_pallas(name):
    q, k, v, mask, kw, ref_out, ref_lse = _sweep(name)
    out, lse = cuda_flash.flash_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), **kw,
    )
    _close(out, ref_out)
    _close(lse, ref_lse)
    if SWEEPS[name][3] is True:  # the all-False row averages V over every key
        mean_v = v[-1].mean(axis=1)  # (hk, d)
        g = q.shape[1] // k.shape[1]
        expect = np.repeat(mean_v, g, axis=0)[:, None, :]
        np.testing.assert_allclose(out[-1].numpy(), np.broadcast_to(
            expect, out[-1].shape), atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None)])
def test_cuda_flash_attention_matches_pallas(causal, window):
    q, k, v, mask = make_inputs(1, nq=128)
    ref = pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal=causal, window=window, interpret=True,
    )
    out = cuda_flash.cuda_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), causal=causal, window=window,
    )
    _close(out, ref)


@pytest.mark.parametrize("nq", [1, 3])
def test_cuda_flash_decode_matches_pallas(nq):
    """h=8 against hk=2: the group of 4 folds onto 4*nq query rows."""
    q, k, v, mask = make_inputs(2, h=8, hk=2, nq=nq, nk=96)
    ref_out, ref_lse = pallas_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        softclamp_value=5.0, interpret=True,
    )
    out, lse = cuda_flash.cuda_flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), softclamp_value=5.0,
    )
    _close(out, ref_out)
    _close(lse, ref_lse)


def test_band_empty_rows_follow_the_oracle():
    """Causal with nq > nk leaves the first nq - nk rows without a key in
    their band; like ``default_attention`` (and unlike the Pallas kernel,
    which writes zeros for such query blocks) the port averages V over all
    keys there."""
    from ring_attention_tpu.ops import default_attention

    q, k, v, _ = make_inputs(5, nq=96, nk=48)
    ref = default_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    out = cuda_flash.cuda_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True
    )
    _close(out, ref)
    g = q.shape[1] // k.shape[1]
    mean_v = np.repeat(v.mean(axis=2), g, axis=1)  # (b, h, d)
    np.testing.assert_allclose(out[:, :, 0].numpy(), mean_v, atol=ATOL)


def test_cpu_calls_never_count_as_launches():
    """The launch counters move only where a CUDA kernel launches: a
    forward and backward on CPU tensors leaves all three where they were."""
    q, k, v, _ = make_inputs(3, nq=8, nk=8)
    counts = (cuda_flash.launch_count, cuda_flash.dkv_launch_count,
              cuda_flash.dq_launch_count)
    q = torch.from_numpy(q).requires_grad_()
    out = cuda_flash.cuda_flash_attention(
        q, torch.from_numpy(k), torch.from_numpy(v), causal=True
    )
    out.sum().backward()
    assert (cuda_flash.launch_count, cuda_flash.dkv_launch_count,
            cuda_flash.dq_launch_count) == counts


def test_no_silent_fallback_on_other_devices():
    """A tensor that is neither on the CPU nor on CUDA raises instead of
    taking the plain version."""
    q = torch.empty((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_flash.flash_fwd(q, q, q, scale=0.125)


def test_backward_raises_until_the_training_slice():
    """The training slice has arrived: the backward that used to raise now
    gives finite gradients of the right shapes for q, k and v (held to the
    JAX package in ``test_torch_flash_bwd.py``), and a tensor on a device
    with no kernel still raises instead of taking the plain version."""
    q, k, v, _ = make_inputs(4, nq=8, nk=8)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = cuda_flash.cuda_flash_attention(q, k, v, causal=True)
    out.sum().backward()
    for x in (q, k, v):
        assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())
    m = torch.empty((1, 2, 4, 64), device="meta")
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_flash.flash_bwd(m, m, m, m, lse, lse, scale=0.125)
