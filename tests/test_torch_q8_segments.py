"""Parity: the int8 sweep's packed-sequence inputs (K3c) and the fused
ring's int8 feed (K4, B7) and int8 wire (B8), port vs JAX package, on the
CPU.

The port's kernel wrappers run their plain versions on CPU tensors; the
JAX side runs the TPU kernels in the Pallas interpreter on the same numpy
inputs.  Float32 on both sides; out within a norm-relative ``OUT_REL_TOL``
and lse within ``LSE_TOL`` (``test_torch_q8.py``'s: the two sides quantize
q, k, v and p identically, and a rare p8 unit flips where the two
exponentials differ in their last bit).

- The int8 sweep with document ids (``q_seg``/``kv_seg``, JAX
  ``segment_ids=(q, kv)``) and with a declared packing (``doc_starts``, JAX
  ``doc_starts=``, its compact doc grid) in its four modes (fused, seed,
  resume, fused from a carry), over causal, windowed and non-causal bands,
  aligned and misaligned packings; the quantization block covers every key
  of its block whatever its document, on both sides.
- B7's int8 feed: ``cuda_ring.fused_ring_local(kv_quantized=)`` per rank
  against ``pallas_ring.fused_ring_local(kv_quantized=)`` on the same
  gathered feed, with and without ids, the hop tables the scan ring's; and,
  exactly, against the port's own int8 hop chain (the scan ring fed the same
  per-stream feed, and a chain of ``flash_partials_q8`` calls).
- B8's int8 wire: ``cuda_ring_remote.fused_ring_remote(compute_dtype=
  "int8")``, each rank's feed read off its ``pack_kv(v_block=n_local)``
  payload, against the JAX local tier on the same feed with ``block_k =
  n_local`` (the same function; JAX's remote tier does not run on a CPU),
  and, exactly, against the port's scan ring fed the same payloads
  (``bucket_size=n_local``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.ops import pallas_flash as jpf
from ring_attention_tpu.ops import pallas_ring as jpr
from ring_attention_tpu.ops import quant as jquant
from ring_attention_tpu.parallel import ring as jring
from ring_attention_tpu_torch.ops import cuda_flash as cf
from ring_attention_tpu_torch.ops import cuda_flash_q8 as q8
from ring_attention_tpu_torch.ops import cuda_ring, cuda_ring_remote, quant
from ring_attention_tpu_torch.ops.attention import doc_runtime_ids
from ring_attention_tpu_torch.ops.partials import FlashPartials, finalize_partials
from ring_attention_tpu_torch.parallel import VirtualRing, ring_flash_attention
from ring_attention_tpu_torch.parallel import ring as pring

OUT_REL_TOL = 1e-3
LSE_TOL = 1e-4


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# name: (n, causal_offset, window_lo, doc starts, block_k)
SWEEP_CASES = {
    "causal_misaligned": (96, 0, None, (0, 23, 60), 32),
    "causal_aligned": (128, 0, None, (0, 64), 64),
    "windowed_blocks16": (96, 0, -40, (0, 50, 51), 16),
    "noncausal": (64, None, None, (0, 40), 32),
}
MODES = ("fused", "seed", "resume", "fused_carry")


@functools.cache
def _sweep_inputs(case):
    n, hi, lo, starts, bk = SWEEP_CASES[case]
    rng = np.random.default_rng(17)
    q, k, v = _np((2, 4, n, 64), rng), _np((2, 2, n, 64), rng), _np((2, 2, n, 64), rng)
    kw = dict(scale=0.125, causal_offset=hi, window_lo=lo, block_k=bk)
    k0, v0 = _np(k.shape, rng), _np(v.shape, rng)
    carry = jpf.pallas_flash_partials(jnp.asarray(q), jnp.asarray(k0), jnp.asarray(v0),
                                      scale=0.125, interpret=True)
    return q, k, v, kw, starts, tuple(np.array(x) for x in carry)


@functools.cache
def _jax_sweep(case, mode, declared):
    q, k, v, kw, starts, carry = _sweep_inputs(case)
    ids = jnp.asarray(doc_runtime_ids(starts, q.shape[2], q.shape[0]).numpy())
    packing = dict(doc_starts=starts) if declared else dict(segment_ids=(ids, ids))
    fused = mode in ("fused", "fused_carry")
    fn = jpf.pallas_flash_fused if fused else jpf.pallas_flash_partials
    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
             compute_dtype="int8",
             carry=jpf.FlashPartials(*map(jnp.asarray, carry))
             if mode in ("resume", "fused_carry") else None, **packing, **kw)
    if not fused:
        out = finalize_partials(FlashPartials(*(torch.from_numpy(np.array(x)) for x in out)))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("declared", [False, True], ids=["ids", "doc_starts"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_q8_sweep_with_ids_equals_pallas(case, mode, declared):
    q, k, v, kw, starts, carry = _sweep_inputs(case)
    ids = doc_runtime_ids(starts, q.shape[2], q.shape[0])
    packing = dict(doc_starts=starts) if declared else dict(q_seg=ids, kv_seg=ids)
    tcarry = (FlashPartials(*map(torch.from_numpy, carry))
              if mode in ("resume", "fused_carry") else None)
    fused = mode in ("fused", "fused_carry")
    fn = cf.flash_fwd if fused else cf.flash_partials
    got = fn(*map(torch.from_numpy, (q, k, v)), carry=tcarry, compute_dtype="int8",
             **packing, **kw)
    out, lse = got if fused else finalize_partials(got)
    ref_out, ref_lse = _jax_sweep(case, mode, declared)
    rel, lse_err = _rel(out.numpy(), ref_out), np.abs(lse.numpy() - ref_lse).max()
    print(f"{case} {mode} declared={declared}: rel {rel:.2e} lse {lse_err:.2e}")
    assert rel <= OUT_REL_TOL and lse_err <= LSE_TOL
    # the packing is part of the function: the unpacked sweep differs
    plain = fn(*map(torch.from_numpy, (q, k, v)), carry=tcarry, compute_dtype="int8", **kw)
    assert _rel((plain if fused else finalize_partials(plain))[0].numpy(), ref_out) > 1e-2


def test_q8_doc_tables_certify_at_b4s_geometry():
    """B4's doc-tile tables (64-row warpgroups, 64-key tiles) are proven
    with B1's, B2's and B3's by the mask certificate."""
    from ring_attention_tpu_torch import masks

    cert = masks.certify(masks.Causal() & masks.DocumentMask((0, 64, 192)), 320,
                         use_cache=False)
    assert cert.ok, cert.violations
    tiles = dict(cert.tiles)
    assert tiles["fwd_q8 bf16"] == tiles["fwd bf16"] < dict(
        masks.certify(masks.Causal(), 320, use_cache=False).tiles)["fwd_q8 bf16"]


# ---------------------------------------------------------------------------
# B7's int8 feed and B8's int8 wire
# ---------------------------------------------------------------------------

RING, N_LOCAL, BLOCK = 4, 32, 16


@functools.cache
def _ring_inputs():
    rng = np.random.default_rng(23)
    n = RING * N_LOCAL
    q, k, v = _np((2, 4, n, 64), rng), _np((2, 2, n, 64), rng), _np((2, 2, n, 64), rng)
    ids = np.repeat(np.int32([0, 1, 2, 3]), [30, 41, 35, n - 106])[None].repeat(2, 0)
    return q, k, v, ids


def _tables(rank, striped):
    port = pring._fused_tables(rank, RING, N_LOCAL, True, striped, None, RING)
    jax_tables = jring._fused_tables(rank, RING, N_LOCAL, True, striped, None, RING)
    for p, j in zip(port, jax_tables):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    return port


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "ids"])
@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
def test_fused_ring_local_int8_feed_equals_pallas(striped, packed):
    q, k, v, ids = _ring_inputs()
    feed = quant.quantize_kv_blocks(torch.from_numpy(k), torch.from_numpy(v), BLOCK)
    jfeed = jquant.quantize_kv_blocks(jnp.asarray(k), jnp.asarray(v), BLOCK)
    for a, b in zip(feed[:4], jfeed[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for rank in range(RING):
        rows = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
        origins, his, los, works = _tables(rank, striped)
        kw = dict(origins=origins, his=his, los=los, works=works, n_local=N_LOCAL,
                  scale=0.125)
        seg = dict(q_seg=torch.from_numpy(ids[:, rows]), kv_seg=torch.from_numpy(ids)) \
            if packed else {}
        out, lse = cuda_ring.fused_ring_local(torch.from_numpy(q[:, :, rows]), None, None,
                                              kv_quantized=feed, block_k=BLOCK, **seg, **kw)
        jseg = dict(q_segment_ids=jnp.asarray(ids[:, rows]),
                    kv_segment_ids=jnp.asarray(ids)) if packed else {}
        ref_out, ref_lse = jpr.fused_ring_local(
            jnp.asarray(q[:, :, rows]), jnp.asarray(k), jnp.asarray(v),
            origins=jnp.asarray(origins.numpy()), his=jnp.asarray(his.numpy()),
            los=jnp.asarray(los.numpy()), works=jnp.asarray(works.numpy()),
            n_local=N_LOCAL, scale=0.125, block_k=BLOCK, kv_quantized=jfeed,
            interpret=True, **jseg)
        rel = _rel(out.numpy(), ref_out)
        assert rel <= OUT_REL_TOL, (rank, rel)
        assert np.abs(lse.numpy() - np.asarray(ref_lse)).max() <= LSE_TOL, rank


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "ids"])
def test_fused_ring_local_int8_equals_the_b4_chain(packed):
    """B7's int8 plain version is the hop chain: each live hop's
    ``flash_partials_q8`` on the origin's slice of the feed, resumed, and
    the last fused; and the fused int8 ring equals the scan int8 ring."""
    q, k, v, ids = _ring_inputs()
    feed = q8.quantize_kv_feed(torch.from_numpy(k), torch.from_numpy(v), BLOCK)
    rank = 3
    rows = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
    tq = torch.from_numpy(q[:, :, rows])
    origins, his, los, works = _tables(rank, False)
    seg = dict(q_seg=torch.from_numpy(ids[:, rows]), kv_seg=torch.from_numpy(ids)) \
        if packed else {}
    out, lse = cuda_ring.fused_ring_local(tq, None, None, kv_quantized=feed, block_k=BLOCK,
                                          origins=origins, his=his, los=los, works=works,
                                          n_local=N_LOCAL, scale=0.125, **seg)
    carry = None
    live = [i for i in range(RING) if works[i]]
    for i in live:
        o = int(origins[i])
        hop = cuda_ring._feed_rows(feed, o, N_LOCAL)
        kw = dict(scale=0.125, causal_offset=int(his[i]), window_lo=int(los[i]),
                  block_k=BLOCK, kv_quantized=hop, carry=carry)
        if packed:
            kw.update(q_seg=seg["q_seg"], kv_seg=seg["kv_seg"][:, o * N_LOCAL:(o + 1) * N_LOCAL])
        if i == live[-1]:
            ref_out, ref_lse = q8.flash_fwd_q8(tq, None, None, **kw)
        else:
            carry = q8.flash_partials_q8(tq, None, None, **kw)
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())
    t = [torch.from_numpy(x) for x in (q, k, v)]
    sg = torch.from_numpy(ids) if packed else None
    with torch.no_grad():
        fused = ring_flash_attention(*t, torch.ones(2, RING * N_LOCAL, dtype=torch.bool),
                                     VirtualRing(RING), causal=True, bucket_size=BLOCK,
                                     impl="fused", compute_dtype="int8", segment_ids=sg)
        scan = ring_flash_attention(*t, torch.ones(2, RING * N_LOCAL, dtype=torch.bool),
                                    VirtualRing(RING), causal=True, bucket_size=BLOCK,
                                    impl="cuda", compute_dtype="int8", segment_ids=sg)
    np.testing.assert_array_equal(fused.numpy(), scan.numpy())


def _remote_feeds(k, v):
    """Each rank's K/V as the remote tier's int8 wire carries it."""
    return [quant.payload_kernel_feed(
        quant.pack_kv(torch.from_numpy(np.ascontiguousarray(k[:, :, r * N_LOCAL:(r + 1) *
                                                              N_LOCAL])),
                      torch.from_numpy(np.ascontiguousarray(v[:, :, r * N_LOCAL:(r + 1) *
                                                              N_LOCAL])),
                      v_block=N_LOCAL), N_LOCAL)
        for r in range(RING)]


@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
def test_fused_ring_remote_int8_equals_pallas(striped):
    q, k, v, _ = _ring_inputs()
    feeds = _remote_feeds(k, v)
    tables = [_tables(r, striped) for r in range(RING)]
    qs = [torch.from_numpy(np.ascontiguousarray(q[:, :, r * N_LOCAL:(r + 1) * N_LOCAL]))
          for r in range(RING)]
    outs, lses = cuda_ring_remote.fused_ring_remote(qs, None, None, tables=tables,
                                                    n_local=N_LOCAL, scale=0.125,
                                                    compute_dtype="int8", kv_quantized=feeds)
    gathered = jquant.QuantizedBlockKV(
        *(jnp.concatenate([jnp.asarray(f[i].numpy()) for f in feeds], axis=2)
          for i in range(4)), N_LOCAL)
    for r in range(RING):
        origins, his, los, works = tables[r]
        ref_out, ref_lse = jpr.fused_ring_local(
            jnp.asarray(qs[r].numpy()), jnp.asarray(k), jnp.asarray(v),
            origins=jnp.asarray(origins.numpy()), his=jnp.asarray(his.numpy()),
            los=jnp.asarray(los.numpy()), works=jnp.asarray(works.numpy()),
            n_local=N_LOCAL, scale=0.125, block_k=N_LOCAL, kv_quantized=gathered,
            interpret=True)
        assert _rel(outs[r].numpy(), ref_out) <= OUT_REL_TOL, r
        assert np.abs(lses[r].numpy() - np.asarray(ref_lse)).max() <= LSE_TOL, r


@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
def test_fused_ring_remote_int8_equals_the_b4_chain(striped):
    """B8's int8 wire is the scan int8 ring fed the same v_block=n_local
    payloads, bit for bit; the fused int8 ring on a VirtualRing takes it."""
    q, k, v, _ = _ring_inputs()
    t = [torch.from_numpy(x) for x in (q, k, v)]
    cuda_ring_remote.q8_launch_count = 0
    with torch.no_grad():
        scan = ring_flash_attention(*t, None, VirtualRing(RING), causal=True, striped=striped,
                                    bucket_size=N_LOCAL, impl="cuda", compute_dtype="int8",
                                    hop_compression="int8")
        fused = ring_flash_attention(*t, None, VirtualRing(RING), causal=True, striped=striped,
                                     bucket_size=BLOCK, impl="fused", compute_dtype="int8",
                                     hop_compression="int8")
    np.testing.assert_array_equal(fused.numpy(), scan.numpy())
    assert cuda_ring_remote.q8_launch_count == 0  # a CPU run counts no launch


def test_an_empty_int8_row_averages_what_each_side_visits():
    """A row whose document's keys are all masked (a key mask beside the
    causal band, at the kernel level) averages the dequantized V over the
    keys it visits, as the float sweep does
    (``test_torch_packing.py::test_an_empty_row_averages_what_each_side_visits``):
    the port's plain int8 version over every key, the JAX int8 kernel over
    its doc grid's tiles (ROADMAP.md Queue 3; on the card B4's kDocs over
    its document's 64-key tiles, its kSeg over the band's)."""
    rng = np.random.default_rng(31)
    q, k, v = _np((1, 2, 128, 64), rng), _np((1, 2, 128, 64), rng), _np((1, 2, 128, 64), rng)
    starts, bk = (0, 64), 32
    mask = np.ones((1, 128), bool)
    mask[0, 64:] = False  # the second document sees no key
    band = dict(scale=0.125, causal_offset=0, block_k=bk)
    out, _ = cf.flash_fwd(*map(torch.from_numpy, (q, k, v, mask)), compute_dtype="int8",
                          doc_starts=starts, **band)
    jout, _ = jpf.pallas_flash_fused(*(jnp.asarray(x) for x in (q, k, v, mask)),
                                     compute_dtype="int8", block_q=32, interpret=True,
                                     doc_starts=starts, **band)
    jout = np.asarray(jout)
    assert _rel(out[:, :, :64].numpy(), jout[:, :, :64]) <= OUT_REL_TOL
    v_deq = quant.dequantize_blocks(*quant.quantize_blocks(torch.from_numpy(v), bk), bk,
                                    torch.float32).numpy()
    np.testing.assert_allclose(out[:, :, 64:].numpy(),
                               np.broadcast_to(v_deq.mean(2, keepdims=True), (1, 2, 64, 64)),
                               atol=1e-5)
    # JAX: rows 64..95 visit key tile 64..95, rows 96..127 tiles 64..127
    for rows, keys in ((slice(64, 96), slice(64, 96)), (slice(96, 128), slice(64, 128))):
        want = np.broadcast_to(v_deq[:, :, keys].mean(2, keepdims=True), jout[:, :, rows].shape)
        np.testing.assert_allclose(jout[:, :, rows], want, atol=1e-5)
