"""Parity: the split-KV decode's plain version (``cuda_flash_decode`` on CPU
tensors, ``flash_decode_reference``) vs the Pallas decode kernel
``pallas_flash_decode`` run in interpret mode, fused (out + lse) and as
partials (acc, m, l).

The plain version splits the keys into ranges of whole 64-key tiles as the
CUDA kernel does and merges the ranges' ``(acc, m, l)`` as its last block
does; the JAX side sweeps all keys at once.  Each case splits 300 keys
(four whole tiles and a ragged one) into 1, 2, 3 and 7 ranges: at 7 the
ranges hold 64 keys, the fifth is ragged (44 keys) and the last two are
empty.  Request 0 attends a valid prefix of 150 keys, so its fourth and
fifth ranges are all masked (``m`` at the mask value, ``l`` their key
count); request 1 a random subset; request 2 no key at all, so it averages V
over all 300 keys and its lse is ``MASK_VALUE + log(300)``, which rounds to
``MASK_VALUE`` in float32 on both sides.  Layouts: h8/hk2 (a group of 4 per
kv head), MQA (hk 1) and h = hk, at nq 1 and 2, with and without softclamp.

Tolerance: float32 on both sides, 2e-5 absolute plus 1e-5 relative: the
two sum the same terms in another order (the ranges, then their merge),
and an unnormalized ``acc`` of up to ~20 carries a relative rounding of a
few 1e-7.  The kernel itself (CUDA tensors) is held to the same plain
version on the GPU by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.ops.pallas_flash import pallas_flash_decode
from ring_attention_tpu_torch.ops import MASK_VALUE, cuda_flash

ATOL, RTOL = 2e-5, 1e-5
NK, D = 300, 64
VALID_PREFIX = 150

# name: (h, hk, nq, softclamp)
CASES = {
    "h8 hk2 nq1": (8, 2, 1, None),
    "h8 hk2 nq2 softclamp": (8, 2, 2, 5.0),
    "mqa h8 hk1 nq1": (8, 1, 1, None),
    "h4 hk4 nq2 softclamp": (4, 4, 2, 30.0),
}


@functools.cache
def make_inputs(name):
    h, hk, nq, _ = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name))
    q = r.standard_normal((3, h, nq, D)).astype(np.float32)
    k = r.standard_normal((3, hk, NK, D)).astype(np.float32)
    v = r.standard_normal((3, hk, NK, D)).astype(np.float32)
    mask = np.zeros((3, NK), dtype=bool)
    mask[0, :VALID_PREFIX] = True
    mask[1] = r.random(NK) > 0.4
    return q, k, v, mask  # request 2: every key masked


@functools.cache
def jax_decode(name, fused):
    q, k, v, mask = make_inputs(name)
    res = pallas_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        softclamp_value=CASES[name][3], fused=fused, interpret=True,
    )
    return tuple(np.asarray(x) for x in res)


def torch_decode(name, fused, splits):
    q, k, v, mask = (torch.from_numpy(x) for x in make_inputs(name))
    return cuda_flash.cuda_flash_decode(q, k, v, mask, softclamp_value=CASES[name][3],
                                        fused=fused, splits=splits)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_decode_matches_pallas(name, splits):
    out, lse = torch_decode(name, True, splits)
    ref_out, ref_lse = jax_decode(name, True)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=RTOL)
    # the request with no valid key: the mean of V, lse at the mask value
    h, hk, _, _ = CASES[name]
    v = make_inputs(name)[2]
    mean_v = np.repeat(v[2].mean(axis=1), h // hk, axis=0)[:, None, :]
    np.testing.assert_allclose(out[2].numpy(), np.broadcast_to(mean_v, out[2].shape),
                               atol=ATOL)
    assert bool((lse[2] == np.float32(MASK_VALUE + np.log(NK))).all())


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("name", list(CASES))
def test_partials_decode_matches_pallas(name, splits):
    got = torch_decode(name, False, splits)
    ref = jax_decode(name, False)
    for x, r in zip(got, ref):
        assert tuple(x.shape) == r.shape
        np.testing.assert_allclose(x.numpy(), r, atol=ATOL, rtol=RTOL)
    # the request with no valid key: m at the mask value, every key counted in l
    acc, m, l = got
    assert bool((m[2] == MASK_VALUE).all())
    np.testing.assert_allclose(l[2].numpy(), np.full(l[2].shape, NK, np.float32))


def test_ranges_cut_as_the_kernel_cuts_them():
    """Whole 64-key tiles per range; 7 ranges of 300 keys leave two empty,
    and the wrapper's own choice leaves none."""
    assert [cuda_flash.decode_split_size(NK, s) for s in (1, 2, 3, 7)] == [320, 192, 128, 64]
    for heads, nk in ((8, 32768), (32, 4096), (8, 1 << 20), (1, 100)):
        s = cuda_flash.decode_splits(heads, 1, nk, 132)
        assert s >= 1 and (s - 1) * cuda_flash.decode_split_size(nk, s) < nk


def test_cpu_decode_never_counts_as_a_launch():
    before = (cuda_flash.decode_launch_count, cuda_flash.launch_count)
    torch_decode("h8 hk2 nq1", True, 3)
    torch_decode("h8 hk2 nq1", False, None)
    assert (cuda_flash.decode_launch_count, cuda_flash.launch_count) == before


def test_bad_split_count_raises():
    with pytest.raises(ValueError, match="cuda_flash_decode: splits"):
        torch_decode("h8 hk2 nq1", True, 0)
