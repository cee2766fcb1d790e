"""Parity: the ring's int8 wire (``hop_compression="int8"``) and the int8
sweep's pre-quantized K/V feed, port vs JAX package, on the CPU.

- The codec, exactly: ``quant.pack_kv`` bytes (row scales and block
  scales, an all-zero row whose scale is the unsafe 0), ``unpack_kv``
  values, ``payload_kernel_feed`` fields, ``quantize_ring_payload`` /
  ``dequantize_ring_payload`` and their token slices, against
  ``ring_attention_tpu.ops.quant`` and ``parallel.collectives`` on the same
  numpy inputs.  The kernel's operand form of a feed (``kernel_kv``, the
  V^T layout) and its one-tensor blob (``feed_blob``) invert exactly.
- The direct feed: the port's int8 partials fed a payload's feed equal
  the partials of the same K/V quantized by the wrapper, bit for bit (and,
  as JAX pins it, those of the payload unpacked and requantized); both
  within ``OUT_REL_TOL`` / ``LSE_TOL`` (``test_torch_q8.py``'s) of JAX's
  ``pallas_flash_partials(kv_quantized=feed)`` in interpret mode.
- ``ring_flash_attention(hop_compression="int8")`` on a ``VirtualRing(4)``
  against the JAX ring under ``shard_map`` on the 2x4 CPU mesh (impl
  ``"xla"``/``"pallas"``/``"fused"`` for the port's ``"torch"``/``"cuda"``/
  ``"fused"``, the Pallas kernels in interpret mode), with float and int8
  compute, contiguous, striped and windowed, and with segment ids; output
  and gradients within ``OUT_REL_TOL`` norm-relative where both sides run
  the same int8 function.  The port's fused int8 ring takes its remote tier
  on a ``VirtualRing`` (one v block per rank span, JAX ``ring.py:719``),
  which JAX's CPU path never reaches (its local tier quantizes v at the
  fitted block): that ring is held, as JAX holds its int8 rings, to the
  exact float ring within ``Q8_FWD_REL_L2`` norm-relative and
  ``Q8_FWD_MAX_ABS`` (``tests/test_quant.py``), and the remote tier's
  kernel-level parity is in ``test_torch_q8_segments.py``.
  The K/V quantizations of one forward number one per stream.

The model on the int8 ring is held to the JAX model in
``test_torch_int8_ring_model.py``.
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.ops import pallas_flash as jpf
from ring_attention_tpu.ops import quant as jquant
from ring_attention_tpu.parallel import collectives as jcoll
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.parallel import sharding as jsharding
from ring_attention_tpu.utils import resilience
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
from ring_attention_tpu_torch.ops import quant
from ring_attention_tpu_torch.ops.partials import finalize_partials
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    ring_flash_attention,
    stripe_permute,
    stripe_unpermute,
)
from ring_attention_tpu_torch.parallel import collectives as coll

OUT_REL_TOL = 1e-3  # test_torch_q8.py: the same int8 function, a rare p8 unit flip
LSE_TOL = 1e-4
# tests/test_quant.py: an int8 ring against the exact float ring
Q8_FWD_REL_L2 = 2e-2
Q8_FWD_MAX_ABS = 0.12
Q8_GRAD_REL_L2 = 3e-2
FLOAT_REL_TOL = 1e-5  # float compute on the dequantized wire: summation order only


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _kv(seed, shape=(2, 2, 32, 16), zero_rows=True):
    rng = np.random.default_rng(seed)
    k, v = _np(shape, rng), _np(shape, rng)
    if zero_rows:
        k[0, 0, 3] = 0.0  # an all-zero row: the unsafe scale 0 travels
        v[-1, -1, 8:16] = 0.0  # an all-zero block of 8
    return k, v


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v_block", [None, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_kv_equals_jax_byte_for_byte(v_block, dtype):
    k, v = _kv(0)
    jk, jv = (jnp.asarray(x).astype(dtype) for x in (k, v))
    tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (k, v))
    ref = np.asarray(jquant.pack_kv(jk, jv, v_block=v_block))
    got = quant.pack_kv(tk, tv, v_block=v_block)
    assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape == (2, 2, 2, 32, 20)
    np.testing.assert_array_equal(got.numpy(), ref)
    for g, r in zip(quant.unpack_kv(got, torch.float32),
                    jquant.unpack_kv(jnp.asarray(ref), jnp.float32)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if v_block is None:
        return
    feed, jfeed = quant.payload_kernel_feed(got, v_block), jquant.payload_kernel_feed(
        jnp.asarray(ref), v_block)
    assert feed.block == jfeed.block == v_block
    for g, r in zip(feed[:4], jfeed[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert quant.payload_kernel_feed(got[:, :, :, :, :], 24) is None  # 24 does not divide 32


def test_ring_payload_round_trip_equals_jax():
    """quantize_ring_payload is pack_kv with row scales; the round trip is
    within one int8 step of each row's absmax (tests/test_collectives.py)
    and equals JAX's value for value."""
    k, v = _kv(1, zero_rows=False)
    payload = coll.quantize_ring_payload(torch.from_numpy(k), torch.from_numpy(v))
    ref = jcoll.quantize_ring_payload(jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(ref))
    k2, v2 = coll.dequantize_ring_payload(payload, torch.float32)
    jk2, jv2 = jcoll.dequantize_ring_payload(ref, jnp.float32)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(jv2))
    for exact, got in ((k, k2), (v, v2)):
        step = np.abs(exact).max(axis=-1) / 127.0
        np.testing.assert_array_less(np.abs(got.numpy() - exact).max(axis=-1), step + 1e-7)


def test_payload_token_slices_share_scales():
    """A token slice of a payload keeps each row's scale bytes with its
    values; a block-aligned slice's feed is the whole feed's slice
    (tests/test_collectives.py:169, tests/test_quant.py:167)."""
    k, v = _kv(2, zero_rows=False)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    payload = coll.quantize_ring_payload(tk, tv)
    half = coll.dequantize_ring_payload(payload[:, :, :, :8], torch.float32)
    full = coll.dequantize_ring_payload(payload, torch.float32)
    for h, f in zip(half, full):
        np.testing.assert_array_equal(h.numpy(), f[:, :, :8].numpy())
    blocked = quant.pack_kv(tk, tv, v_block=8)
    whole = quant.payload_kernel_feed(blocked, 8)
    part = quant.payload_kernel_feed(blocked[:, :, :, 8:24], 8)
    np.testing.assert_array_equal(part.k_q.numpy(), whole.k_q[:, :, 8:24].numpy())
    np.testing.assert_array_equal(part.k_scale.numpy(), whole.k_scale[:, :, 8:24].numpy())
    np.testing.assert_array_equal(part.v_scale.numpy(), whole.v_scale[:, :, 1:3].numpy())


@pytest.mark.parametrize("block", [8, 24, 32, 96])
def test_kernel_form_and_blob_invert(block):
    """The kernel's operand form (V^T per block, keys permuted, padded to
    64) and its one-tensor blob hold the feed exactly."""
    k, v = _kv(3, shape=(1, 2, 96, 16))
    feed = quant.quantize_kv_blocks(torch.from_numpy(k), torch.from_numpy(v), block)
    kv = q8.kernel_kv(feed)
    assert kv.v8t.shape == (1, 2, 96 // block, 16, -(-block // 64) * 64)
    back = q8.natural_kv(kv)
    for x, y in zip(back[:4], feed[:4]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    blob = q8.feed_blob(kv)
    assert blob.dim() == 1 and blob.dtype == torch.int8 and blob.numel() % 16 == 0
    viewed = q8.blob_kv(blob, 1, 2, 96, 16, block)
    for x, y in zip(viewed[:4], kv[:4]):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---------------------------------------------------------------------------
# the direct feed (K4)
# ---------------------------------------------------------------------------


def test_direct_feed_bitexact_vs_launcher_quant():
    """tests/test_quant.py:342 on the port: the payload's feed and the
    payload unpacked and requantized by the wrapper give the same acc and l;
    and a feed quantized from the exact K/V gives the wrapper's own
    partials bit for bit."""
    rng = np.random.default_rng(4)
    q, k, v = _np((1, 2, 64, 8), rng), _np((1, 2, 64, 8), rng), _np((1, 2, 64, 8), rng)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    kw = dict(scale=8 ** -0.5, causal_offset=0, block_k=16)
    payload = quant.pack_kv(torch.from_numpy(k).to(torch.bfloat16),
                            torch.from_numpy(v).to(torch.bfloat16), v_block=16)
    feed = quant.payload_kernel_feed(payload, 16)
    direct = q8.flash_partials_q8(tq, None, None, kv_quantized=feed, **kw)
    kd, vd = quant.unpack_kv(payload, torch.bfloat16)
    requant = q8.flash_partials_q8(tq, kd, vd, **kw)
    np.testing.assert_array_equal(direct.acc.numpy(), requant.acc.numpy())
    np.testing.assert_array_equal(direct.l.numpy(), requant.l.numpy())
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    launcher = q8.flash_partials_q8(tq.float(), tk, tv, **kw)
    fed = q8.flash_partials_q8(tq.float(), None, None,
                               kv_quantized=q8.quantize_kv_feed(tk, tv, 16), **kw)
    for x, y in zip(fed, launcher):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_direct_feed_equals_pallas(causal):
    rng = np.random.default_rng(5)
    q, k, v = _np((2, 4, 64, 64), rng), _np((2, 2, 64, 64), rng), _np((2, 2, 64, 64), rng)
    kw = dict(scale=0.125, causal_offset=0 if causal else None)
    payload = quant.pack_kv(torch.from_numpy(k), torch.from_numpy(v), v_block=16)
    jfeed = jquant.payload_kernel_feed(jquant.pack_kv(jnp.asarray(k), jnp.asarray(v),
                                                      v_block=16), 16)
    ref = jpf.pallas_flash_partials(jnp.asarray(q), None, None, compute_dtype="int8",
                                    kv_quantized=jfeed, block_k=16, interpret=True, **kw)
    got = q8.flash_partials_q8(torch.from_numpy(q), None, None, block_k=16,
                               kv_quantized=quant.payload_kernel_feed(payload, 16), **kw)
    out, lse = finalize_partials(got)
    ref_out, ref_lse = finalize_partials(type(got)(*(torch.from_numpy(np.array(x))
                                                     for x in ref)))
    assert _rel(out.numpy(), ref_out.numpy()) <= OUT_REL_TOL
    assert np.abs(lse.numpy() - ref_lse.numpy()).max() <= LSE_TOL
    with pytest.raises(ValueError, match="fitted block"):
        q8.flash_partials_q8(torch.from_numpy(q), None, None, block_k=32,
                             kv_quantized=quant.payload_kernel_feed(payload, 16), **kw)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

JAX_IMPLS = {"torch": "xla", "cuda": "pallas", "fused": "fused"}
LAYOUTS = {"contiguous": {}, "striped": dict(striped=True), "windowed": dict(window=40)}
RING_CASES = [(impl, compute, layout) for impl in JAX_IMPLS for compute in (None, "int8")
              for layout in LAYOUTS if not (impl == "torch" and compute)]


def _ring_inputs(seed=30):
    rng = np.random.default_rng(seed)
    q, do = _np((2, 4, 128, 16), rng), _np((2, 4, 128, 16), rng)
    k, v = _np((2, 2, 128, 16), rng), _np((2, 2, 128, 16), rng)
    ids = np.zeros((2, 128), np.int32)
    ids[:, 50:] = 1
    ids[:, 97:] = 2
    return q, k, v, do, ids


@functools.cache
def _jax_ring(impl, compute, layout, packed, wire="int8"):
    q, k, v, do, ids = _ring_inputs()
    kw = LAYOUTS[layout]
    striped = kw.get("striped", False)
    mesh = jax_create_mesh(ring_size=4, data_size=2)
    fn = partial(jax_ring, axis_name="seq", causal=True, bucket_size=16, impl=impl,
                 hop_compression=wire, compute_dtype=compute, **kw)
    qspec = P("data", None, "seq", None)
    sharded = shard_map(lambda q, k, v, s: fn(q, k, v, None, segment_ids=s), mesh=mesh,
                        in_specs=(qspec, qspec, qspec, P("data", "seq") if packed else P()),
                        out_specs=qspec, check_vma=False)
    perm = (lambda x, a=2: jsharding.stripe_permute(x, 4, axis=a)) if striped else (
        lambda x, a=2: x)
    unperm = (lambda x: jsharding.stripe_unpermute(x, 4, axis=2)) if striped else (lambda x: x)
    seg = perm(jnp.asarray(ids), 1) if packed else None

    @jax.jit
    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: unperm(sharded(perm(q), perm(k), perm(v), seg)),
                           q, k, v)
        return out, vjp(do)

    out, grads = out_and_grads(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(impl, compute, layout, packed, wire="int8"):
    q, k, v, do, ids = _ring_inputs()
    kw = LAYOUTS[layout]
    striped = kw.get("striped", False)
    perm = (lambda x, a=2: stripe_permute(x, 4, axis=a)) if striped else (lambda x, a=2: x)
    unperm = (lambda x: stripe_unpermute(x, 4, axis=2)) if striped else (lambda x: x)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    seg = perm(torch.from_numpy(ids), 1) if packed else None
    out = unperm(ring_flash_attention(perm(tq), perm(tk), perm(tv), None, VirtualRing(4),
                                      causal=True, bucket_size=16, impl=impl,
                                      hop_compression=wire, compute_dtype=compute,
                                      segment_ids=seg, **kw))
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("impl,compute,layout", RING_CASES)
def test_int8_ring_equals_jax(impl, compute, layout):
    resilience.reset()
    remote = impl == "fused" and compute == "int8"  # one v block per rank span
    jout, jgrads = (_jax_ring("pallas", None, layout, False, None) if remote
                    else _jax_ring(JAX_IMPLS[impl], compute, layout, False))
    out, grads = _port_ring(impl, compute, layout, False)
    if remote:
        rel, err = _rel(out, jout), np.abs(out - jout).max()
        print(f"{impl} {compute} {layout}: vs the exact float ring: rel {rel:.2e} "
              f"max {err:.2e}")
        assert rel <= Q8_FWD_REL_L2 and err <= Q8_FWD_MAX_ABS
    else:
        rel = _rel(out, jout)
        print(f"{impl} {compute} {layout}: ||ring - jax ring|| / ||jax ring|| {rel:.2e}")
        assert rel <= (OUT_REL_TOL if compute else FLOAT_REL_TOL)
    for g, r in zip(grads, jgrads):  # the exact-residual backward, from (out, lse)
        assert _rel(g, r) <= (Q8_GRAD_REL_L2 if remote else OUT_REL_TOL)


@pytest.mark.parametrize("impl,compute", [("torch", None), ("cuda", None), ("cuda", "int8"),
                                          ("fused", "int8")])
def test_int8_ring_with_segment_ids_equals_jax(impl, compute):
    """tests/test_ring.py:775 and tests/test_quant.py:260: the ids rotate
    uncompressed beside the int8 KV (the fused ring with ids: its local tier,
    B7, at the fitted block, as JAX's)."""
    resilience.reset()
    jout, jgrads = _jax_ring(JAX_IMPLS[impl], compute, "contiguous", True)
    out, grads = _port_ring(impl, compute, "contiguous", True)
    tol = OUT_REL_TOL if compute else FLOAT_REL_TOL
    assert _rel(out, jout) <= tol
    for g, r in zip(grads, jgrads):
        assert _rel(g, r) <= OUT_REL_TOL


def test_int8_compute_is_the_same_function_on_and_off_the_wire():
    """pack_kv quantizes k per row and v per block exactly as the launcher
    does, so the dequant-free ring equals the uncompressed int8 ring bit for
    bit, scan and fused; compression alone dequantizes once per hop."""
    for impl in ("cuda", "fused"):
        on, _ = _port_ring(impl, "int8", "striped", True)
        off, _ = _port_ring(impl, "int8", "striped", True, wire=None)
        np.testing.assert_array_equal(on, off)
    fused, _ = _port_ring("fused", None, "windowed", False)
    scan, _ = _port_ring("cuda", None, "windowed", False)
    assert _rel(fused, scan) <= FLOAT_REL_TOL


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
def test_kv_is_quantized_once_per_stream(impl):
    q, k, v, _, _ = _ring_inputs()
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for compute in (None, "int8") if impl != "torch" else (None,):
        quant.kv_quantize_count = 0
        with torch.no_grad():
            ring_flash_attention(*t, None, VirtualRing(4), causal=True, bucket_size=16,
                                 impl=impl, hop_compression="int8", compute_dtype=compute)
        assert quant.kv_quantize_count == 4, (impl, compute)  # 4 ranks, not 4 x 4 hops
    if impl != "torch":
        quant.kv_quantize_count = 0
        with torch.no_grad():  # uncompressed int8: still once per stream
            ring_flash_attention(*t, None, VirtualRing(4), causal=True, bucket_size=16,
                                 impl="cuda", compute_dtype="int8")
        assert quant.kv_quantize_count == 4
