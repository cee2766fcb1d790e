"""Parity: the int8 serving path of the port vs the JAX package's.

On CPU tensors the int8 kernel wrappers run their plain versions
(``ops/cuda_flash_q8.py``); the JAX side runs the TPU kernels themselves in
the Pallas interpreter (``pallas_flash_fused`` / ``pallas_flash_partials``
/ ``pallas_flash_attention`` with ``compute_dtype="int8"``, and
``pallas_flash_decode_q8``), on the same numpy inputs.

- The int8 forward in its fused, seed, resume and fused-from-carry forms,
  at the same quantization block, over causal, window, key mask, GQA and
  softclamp.  Float32 on both sides; out (finalized partials) within a
  norm-relative 1e-3 and lse within 1e-4.  Both sides quantize q, k, v and
  p identically; the expected difference is a rare one-unit flip of p8
  where the two exponentials differ in their last bit.
- The int8 decode, fused and partials, masked, hk 1, 2 and 4: 3e-5
  absolute (f32 dequantization and softmax, summation order only).
- The model, ``RingTransformer(impl="cuda", quantize_cache=True,
  compute_dtype="int8", device="cpu")`` against the JAX model with
  ``use_pallas=True`` and the same knobs on the same weights: forward
  logits, prefill and 4 decode steps with the quantized cache entries
  themselves, greedy ``generate``, and one train step's gradients (the
  backward runs the float kernels from the int8 forward's out and lse).
- The int8 ring on a ``VirtualRing(4)`` against the JAX ring under
  ``shard_map`` (``impl="pallas"``, interpret mode), contiguous and
  striped, output and gradients.
"""

import copy
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.ops import pallas_flash as jpf
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.parallel import sharding as jsharding
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import RingTransformer, export_jax_params, load_jax_params
from ring_attention_tpu_torch.ops import cuda_flash as cf
from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
from ring_attention_tpu_torch.ops.partials import FlashPartials, finalize_partials
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    ring_flash_attention,
    stripe_permute,
    stripe_unpermute,
)

OUT_REL_TOL = 1e-3
LSE_TOL = 1e-4
DECODE_ATOL = 3e-5


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# name: (b, h, hk, nq, nk, causal_offset, window_lo, softclamp, masked, block_k)
FWD_CASES = {
    "causal": (2, 4, 4, 64, 64, 0, None, None, False, None),
    "causal_offset_blocks16": (1, 4, 4, 32, 96, 64, None, None, False, 16),
    "window_blocks32": (1, 4, 4, 64, 128, 64, 40, None, False, 32),
    "kv_mask_all_false_row": (2, 4, 4, 32, 64, None, None, None, True, 16),
    "gqa_h4_hk2": (1, 4, 2, 64, 64, 0, None, None, False, 32),
    "softclamp": (1, 4, 4, 64, 64, 0, None, 3.0, False, 32),
}
MODES = ("fused", "seed", "resume", "fused_carry")


def _fwd_inputs(case):
    b, h, hk, nq, nk, hi, lo, clamp, masked, bk = FWD_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = _np((b, h, nq, 64), rng), _np((b, hk, nk, 64), rng), _np((b, hk, nk, 64), rng)
    mask = None
    if masked:
        mask = rng.random((b, nk)) > 0.3
        mask[-1] = False
    kw = dict(scale=0.125, causal_offset=hi,
              window_lo=None if lo is None else hi - lo,
              softclamp_value=clamp, block_k=bk)
    # a carry with real content: an unmasked first span, from the JAX kernel
    k0, v0 = _np(k.shape, rng), _np(v.shape, rng)
    carry = jpf.pallas_flash_partials(jnp.asarray(q), jnp.asarray(k0), jnp.asarray(v0),
                                      scale=0.125, interpret=True)
    return q, k, v, mask, kw, tuple(np.array(x) for x in carry)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_q8_forward_equals_pallas(case, mode):
    q, k, v, mask, kw, carry = _fwd_inputs(case)
    resume = mode in ("resume", "fused_carry")
    fused = mode in ("fused", "fused_carry")
    jfn = jpf.pallas_flash_fused if fused else jpf.pallas_flash_partials
    ref = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              None if mask is None else jnp.asarray(mask), interpret=True,
              compute_dtype="int8",
              carry=jpf.FlashPartials(*map(jnp.asarray, carry)) if resume else None, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    tcarry = FlashPartials(*map(torch.from_numpy, carry)) if resume else None
    fn = cf.flash_fwd if fused else cf.flash_partials
    got = fn(tq, tk, tv, tmask, carry=tcarry, compute_dtype="int8", **kw)
    if fused:
        (out, lse), (ref_out, ref_lse) = got, ref
    else:
        out, lse = finalize_partials(got)
        ref_out, ref_lse = finalize_partials(FlashPartials(
            *(torch.from_numpy(np.array(x)) for x in ref)))
    rel = _rel(out.numpy(), ref_out)
    lse_err = np.abs(lse.numpy() - np.asarray(ref_lse)).max()
    print(f"{case} {mode}: ||out - pallas|| / ||pallas|| {rel:.2e}, max|lse diff| {lse_err:.2e}")
    assert rel <= OUT_REL_TOL and lse_err <= LSE_TOL
    if tcarry is not None:  # a resume without out= leaves its carry alone
        np.testing.assert_array_equal(tcarry.acc.numpy(), carry[0])


def test_q8_differs_from_the_float_sweep_and_in_place_resume_matches():
    """The int8 sweep is not the float sweep (it really quantizes), and a
    resume into its own carry equals a resume into new tensors."""
    q, k, v, mask, kw, carry = _fwd_inputs("gqa_h4_hk2")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, _ = cf.flash_fwd(tq, tk, tv, compute_dtype="int8", **kw)
    exact, _ = cf.flash_fwd(tq, tk, tv, **kw)
    assert 1e-3 < _rel(out.numpy(), exact.numpy()) < 2e-2
    tcarry = FlashPartials(*map(torch.from_numpy, carry))
    new = cf.flash_partials(tq, tk, tv, carry=tcarry, compute_dtype="int8", **kw)
    kept = FlashPartials(*(x.clone() for x in tcarry))
    cf.flash_partials(tq, tk, tv, carry=kept, out=kept, compute_dtype="int8", **kw)
    for x, y in zip(kept, new):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("window", [None, 24])
def test_cuda_flash_attention_int8_equals_pallas(window):
    """The differentiable entry point: forward at the JAX launch's default
    block (``min(1024, nk)`` fitted), gradients from the float backward
    kernels run on the int8 forward's out and lse."""
    rng = np.random.default_rng(11)
    q, k, v, do = (_np((2, 4, 48, 16), rng) for _ in range(4))
    k, v = k[:, :2], v[:, :2]

    def jfn(q, k, v):
        return jpf.pallas_flash_attention(q, k, v, causal=True, window=window,
                                          interpret=True, compute_dtype="int8")

    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = cf.cuda_flash_attention(tq, tk, tv, causal=True, window=window,
                                  compute_dtype="int8")
    out.backward(torch.from_numpy(do))
    assert _rel(out.detach().numpy(), ref) <= OUT_REL_TOL
    for x, g in zip((tq, tk, tv), ref_grads):
        assert _rel(x.grad.numpy(), g) <= OUT_REL_TOL


def test_compute_dtype_is_validated():
    x = torch.zeros((1, 2, 8, 64))
    for fn in (cf.flash_fwd, cf.flash_partials):
        with pytest.raises(ValueError, match="compute_dtype='fp8'"):
            fn(x, x, x, scale=0.125, compute_dtype="fp8")
    with pytest.raises(ValueError, match="compute_dtype='fp4'"):
        cf.cuda_flash_attention(x, x, x, compute_dtype="fp4")
    m = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        q8.flash_fwd_q8(m, m, m, scale=0.125)
    with pytest.raises(ValueError, match="no kernel for device"):
        q8.flash_decode_q8(m, q8.QuantizedKV(m.to(torch.int8), m[..., 0], m.to(torch.int8),
                                             m[..., 0]))


@pytest.mark.parametrize("nk,block,expect", [(64, None, 64), (4096, None, 1024),
                                             (1536, None, 512), (96, None, 96),
                                             (16384, 2048, 2048), (48, 32, 16)])
def test_q8_block_equals_the_jax_fit(nk, block, expect):
    assert q8.q8_block(nk, block) == expect == jpf._block_sizes(8, nk, None, block)[1]


# ---------------------------------------------------------------------------
# the int8 decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("hk", [1, 2, 4])
def test_q8_decode_equals_pallas(hk, fused):
    rng = np.random.default_rng(20 + hk)
    b, h, nk = 3, 4, 80
    q = _np((b, h, 1, 64), rng)
    kv = q8.quantize_kv_cache(torch.from_numpy(_np((b, hk, nk, 64), rng)),
                              torch.from_numpy(_np((b, hk, nk, 64), rng)))
    mask = np.arange(nk)[None, :] < np.array([[nk], [37], [1]])
    mask[1, 5] = False
    ref = jpf.pallas_flash_decode_q8(
        jnp.asarray(q), jpf.QuantizedKV(*(jnp.asarray(x.numpy()) for x in kv)),
        jnp.asarray(mask), softclamp_value=5.0, block_k=16, fused=fused, interpret=True)
    got = q8.flash_decode_q8(torch.from_numpy(q), kv, torch.from_numpy(mask),
                             softclamp_value=5.0, fused=fused)
    assert len(got) == len(ref)
    for x, r in zip(got, ref):
        assert tuple(x.shape) == r.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=DECODE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, quantize_cache=True, compute_dtype="int8")
# f32 on both sides through two int8 layers and a 256-way projection; the
# quantized operands are identical, a flipped p8 unit moves a logit ~1e-5
LOGITS_ATOL = 1e-4
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _tokens(seed, b=2, n=33):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_model():
    jm = JaxTransformer(**CONFIG, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port_model():
    jm, params = _jax_model()
    tm = RingTransformer(**CONFIG, impl="cuda", device="cpu")
    return jm, params, load_jax_params(tm, params)


def test_q8_model_logits_equal_jax():
    jm, params, tm = _port_model()
    tokens = _tokens(1)
    ref = jm.apply(params, jnp.asarray(tokens))
    with torch.no_grad():
        logits = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=LOGITS_ATOL, rtol=0)
    exact = RingTransformer(**dict(CONFIG, compute_dtype=None), impl="cuda", device="cpu")
    load_jax_params(exact, params)
    with torch.no_grad():  # the knob is live: the float model differs
        assert (exact(torch.from_numpy(tokens)) - logits).abs().max() > 1e-4


def test_q8_model_prefill_decode_and_cache_equal_jax():
    """Teacher forcing after a 12-token prefill; the int8 cache values and
    their scales are compared entry by entry."""
    jm, params, tm = _port_model()
    tokens = _tokens(2, n=16)
    prompt, rest = tokens[:, :12], tokens[:, 12:]
    jcache = jm.apply(params, 2, 20, method=jm.init_cache)
    jlogits, jcache = jax.jit(partial(jm.apply, method=jm.prefill))(
        params, jnp.asarray(prompt), jcache)
    jdecode = jax.jit(partial(jm.apply, method=jm.decode_step))
    with torch.no_grad():
        cache = tm.init_cache(2, 20)
        assert cache["k"][0][0].dtype == torch.int8 and cache["k"][0][1].dtype == torch.float32
        logits, cache = tm.prefill(torch.from_numpy(prompt), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
        for i in range(rest.shape[1]):
            pos = prompt.shape[1] + i
            jlogits, jcache = jdecode(params, jnp.asarray(rest[:, i]), jcache, jnp.int32(pos))
            logits, cache = tm.decode_step(torch.from_numpy(rest[:, i]), cache, pos)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    for name in ("k", "v"):
        for layer in range(CONFIG["depth"]):
            (values, scales), (jvalues, jscales) = cache[name][layer], jcache[name][layer]
            np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))
            np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-6, atol=0)


def test_q8_model_generate_equals_jax():
    jm, params, tm = _port_model()
    prompt = _tokens(3, n=10)
    ref = jm.apply(params, jnp.asarray(prompt), 24, 8, method=jm.generate)
    out = tm.generate(torch.from_numpy(prompt), 24, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_q8_model_train_step_gradients_equal_jax():
    jm, params, tm = _port_model()
    tokens = _tokens(4)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(tokens), return_loss=True))(params)
    loss = tm(torch.from_numpy(tokens), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    holder = copy.deepcopy(tm)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), tm.parameters()):
            p.copy_(src.grad)
    got = dict(jax.tree_util.tree_leaves_with_path(export_jax_params(holder)))
    for path, ref in jax.tree_util.tree_leaves_with_path(ref_grads):
        np.testing.assert_allclose(got[path], np.asarray(ref), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def _jax_q8_ring(q, k, v, do, *, striped, bucket):
    mesh = jax_create_mesh(ring_size=4, data_size=2)
    fn = partial(jax_ring, axis_name="seq", causal=True, striped=striped,
                 bucket_size=bucket, impl="pallas", compute_dtype="int8")
    qspec = P("data", None, "seq", None)
    sharded = shard_map(fn, mesh=mesh, in_specs=(qspec, qspec, qspec, P()),
                        out_specs=qspec, check_vma=False)
    perm = (lambda x: jsharding.stripe_permute(x, 4, axis=2)) if striped else (lambda x: x)
    unperm = (lambda x: jsharding.stripe_unpermute(x, 4, axis=2)) if striped else (lambda x: x)
    out, vjp = jax.vjp(lambda q, k, v: unperm(sharded(perm(q), perm(k), perm(v), None)),
                       *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("striped", [False, True])
def test_q8_ring_equals_jax(striped):
    """Ring of 4, shards of 32 quantized per block of 16 (the bucket)."""
    rng = np.random.default_rng(30)
    q, do = _np((2, 4, 128, 16), rng), _np((2, 4, 128, 16), rng)
    k, v = _np((2, 2, 128, 16), rng), _np((2, 2, 128, 16), rng)
    jout, jgrads = _jax_q8_ring(q, k, v, do, striped=striped, bucket=16)
    perm = (lambda x: stripe_permute(x, 4, axis=2)) if striped else (lambda x: x)
    unperm = (lambda x: stripe_unpermute(x, 4, axis=2)) if striped else (lambda x: x)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = unperm(ring_flash_attention(perm(tq), perm(tk), perm(tv), None, VirtualRing(4),
                                      causal=True, striped=striped, bucket_size=16,
                                      impl="cuda", compute_dtype="int8"))
    out.backward(torch.from_numpy(do))
    rel = _rel(out.detach().numpy(), jout)
    print(f"striped={striped}: ||ring - jax ring|| / ||jax ring|| {rel:.2e}")
    assert rel <= OUT_REL_TOL
    for x, g in zip((tq, tk, tv), jgrads):
        assert _rel(x.grad.numpy(), g) <= OUT_REL_TOL


def test_q8_ring_validates_compute_dtype():
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="supported values are None"):
        ring_flash_attention(x, x, x, None, VirtualRing(2), impl="cuda", compute_dtype="fp8")
    with pytest.raises(ValueError, match='pass impl="cuda"'):
        ring_flash_attention(x, x, x, None, VirtualRing(2), impl="torch",
                             compute_dtype="int8")
