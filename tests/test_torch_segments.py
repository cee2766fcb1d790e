"""Parity: packed sequences (segment ids) in the port vs the JAX package.

The same numpy inputs and per-token document ids go through the JAX
functions and their port, as ``tests/test_segments.py`` runs the JAX side
(its Pallas kernels in interpret mode, the ids passed the same way):

- the dense oracle ``default_attention`` and the blockwise
  ``flash_attention`` (forward and gradients) against JAX's own;
- the plain versions of the CUDA kernels (``flash_fwd`` /
  ``flash_partials`` in the fused, seed and resume modes, ``flash_bwd``;
  CPU tensors take them) against ``pallas_flash_attention``,
  ``pallas_flash_partials``, ``pallas_flash_fused`` and
  ``pallas_flash_backward``;
- ``ring_flash_attention`` on ``VirtualRing(2)`` and ``(4)``, contiguous
  and striped, ``impl="torch"`` and ``"cuda"``, against the JAX ring under
  ``shard_map``, with the hops the document ids skip counted as JAX's
  ``_hop_has_work`` skips them;
- ``RingAttention`` and ``RingTransformer`` logits, loss and gradients,
  locally and on a mesh, against the JAX models with the same weights, and
  the packed loss against the same documents as separate rows.

Cases: causal and not, GQA, a window, softclamp, a key mask, a
``PAD_SEGMENT_ID`` tail, document boundaries inside tiles, and
cross-document weights exactly zero.  Tolerances are the existing parity
tests': outputs 2e-5 (``test_torch_ops.py``), flash gradients 5e-5
(``test_torch_flash_bwd.py``), ring gradients 5e-4 (``test_torch_ring.py``),
model gradients 2e-5 absolute plus 1e-4 relative
(``test_torch_ring_model.py``); float32 on both sides.
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

from ring_attention_tpu.models import RingAttention as JaxAttention
from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.ops import default_attention as jax_default_attention
from ring_attention_tpu.ops.flash import flash_attention as jax_flash_attention
from ring_attention_tpu.ops.pallas_flash import (
    pallas_flash_attention,
    pallas_flash_backward,
    pallas_flash_fused,
    pallas_flash_partials,
)
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring as jring
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.parallel import sharding as jsharding
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import (
    PAD_SEGMENT_ID,
    RingAttention,
    RingTransformer,
    SegmentIds,
    cuda_flash_attention,
    default_attention,
    export_jax_params,
    flash_attention,
    load_jax_params,
)
from ring_attention_tpu_torch.ops import cuda_flash as cf
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    ring_flash_attention,
    stripe_permute,
    stripe_unpermute,
)
from ring_attention_tpu_torch.parallel import ring as pring

ATOL = 2e-5
FLASH_GRAD_ATOL = 5e-5
RING_GRAD_ATOL = 5e-4
MODEL_GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def make_seg(b, bounds, n, pad_tail=0):
    """``(b, n)`` int32 ids for documents starting at ``bounds`` (the first
    0), the last ``pad_tail`` tokens ``PAD_SEGMENT_ID``."""
    ids = np.zeros(n, np.int32)
    for doc, start in enumerate(bounds):
        ids[start:] = doc
    if pad_tail:
        ids[n - pad_tail:] = PAD_SEGMENT_ID
    return np.broadcast_to(ids, (b, n)).copy()


def make_qkv(seed, b=2, h=4, hk=2, n=64, d=16):
    r = np.random.default_rng(seed)
    q, do = (r.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2))
    k, v = (r.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


# name: (causal, hk, window, softclamp, masked, bounds, pad_tail); boundaries
# fall inside the blockwise path's buckets of 16 and the Pallas blocks of 32
CASES = {
    "causal": (True, 4, None, None, False, (0, 23, 48), 0),
    "noncausal_kv_mask": (False, 4, None, None, True, (0, 23, 48), 0),
    "gqa_pad_tail": (True, 2, None, None, False, (0, 9, 30), 11),
    "window": (True, 2, 13, None, False, (0, 23, 48), 0),
    "softclamp": (True, 4, None, 3.0, False, (0, 17, 40, 41), 0),
}


def _case_inputs(name, seed=0):
    causal, hk, window, clamp, masked, bounds, pad = CASES[name]
    q, k, v, do = make_qkv(seed, hk=hk)
    b, n = q.shape[0], q.shape[2]
    seg = make_seg(b, bounds, n, pad)
    mask = None
    if masked:
        mask = np.random.default_rng(seed + 1).random((b, n)) > 0.3
    kw = dict(causal=causal, window=window, softclamp_value=clamp)
    return q, k, v, do, seg, mask, kw


# ---------------------------------------------------------------------------
# the dense oracle and the blockwise flash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["causal", "noncausal_kv_mask", "gqa_pad_tail",
                                  "softclamp"])
def test_default_attention_matches_jax(name):
    q, k, v, _, seg, mask, kw = _case_inputs(name)
    kw.pop("window")
    got = default_attention(*_t(q, k, v), None if mask is None else torch.from_numpy(mask),
                            segment_ids=torch.from_numpy(seg), **kw)
    ref = jax_default_attention(*_j(q, k, v), None if mask is None else jnp.asarray(mask),
                                segment_ids=jnp.asarray(seg), **kw)
    _close(got, ref)


@pytest.mark.parametrize("kv_bounds", [(0, 5), (0, 40), (0, 64)])
def test_segments_overlap_matches_jax(kv_bounds):
    """The conservative id-range test that skips buckets and ring hops."""
    from ring_attention_tpu.ops.attention import segments_overlap as jax_overlap
    from ring_attention_tpu_torch import segments_overlap

    q_seg = make_seg(2, (0, 30), 64) + 1  # documents 1 and 2
    kv_seg = make_seg(2, kv_bounds, 64)  # documents 0 and 1, or 0 alone
    assert segments_overlap(*_t(q_seg, kv_seg)) == bool(jax_overlap(*_j(q_seg, kv_seg)))
    assert segments_overlap(*_t(q_seg, kv_seg)) == (kv_bounds[1] < 64)


@functools.cache
def _jax_flash(name):
    q, k, v, do, seg, mask, kw = _case_inputs(name)
    jmask = None if mask is None else jnp.asarray(mask)
    fn = lambda q, k, v: jax_flash_attention(q, k, v, jmask, bucket_size=16,
                                             segment_ids=jnp.asarray(seg), **kw)
    out, vjp = jax.vjp(fn, *_j(q, k, v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_fwd_and_grads_match_jax(name):
    q, k, v, do, seg, mask, kw = _case_inputs(name)
    ref, ref_grads = _jax_flash(name)
    x = [a.requires_grad_() for a in _t(q, k, v)]
    out = flash_attention(*x, None if mask is None else torch.from_numpy(mask),
                          bucket_size=16, segment_ids=torch.from_numpy(seg), **kw)
    _close(out.detach(), ref)
    out.backward(torch.from_numpy(do))
    for label, a, g in zip("qkv", x, ref_grads):
        _close(a.grad, g, FLASH_GRAD_ATOL)


def test_flash_attention_ragged_kv_pads_ids_and_takes_a_pair():
    """A ``(q_ids, kv_ids)`` pair with ``nq < nk`` and ``nk`` not a multiple
    of the bucket: the pad keys take ``PAD_SEGMENT_ID`` and the pair equals
    JAX's, forward and gradients."""
    q, k, v, do = make_qkv(5, n=60)
    q, do = q[:, :, :24], do[:, :, :24]
    kv_seg = make_seg(2, (0, 21, 50), 60)
    q_seg = kv_seg[:, -24:]
    x = [a.requires_grad_() for a in _t(q, k, v)]
    out = flash_attention(*x, causal=True, bucket_size=16,
                          segment_ids=SegmentIds(*_t(q_seg, kv_seg)))
    out.backward(torch.from_numpy(do))
    fn = lambda q, k, v: jax_flash_attention(q, k, v, causal=True, bucket_size=16,
                                             segment_ids=tuple(_j(q_seg, kv_seg)))
    ref, vjp = jax.vjp(fn, *_j(q, k, v))
    _close(out.detach(), ref)
    for a, g in zip(x, vjp(jnp.asarray(do))):
        _close(a.grad, g, FLASH_GRAD_ATOL)


@pytest.mark.parametrize("bucket_size", [None, 16])
def test_flash_attention_queries_without_their_document_match_jax(bucket_size):
    """Queries whose id no key carries: one bucket is never skipped (such a
    row averages V, as the oracle's), buckets whose id range meets no
    query's are (their rows keep an empty carry), as in JAX."""
    q, k, v, _ = make_qkv(9)
    q_seg = make_seg(2, (0, 32), 64) + 4  # documents 4 and 5
    kv_seg = make_seg(2, (0, 16, 48), 64) + 3  # documents 3, 4 and 5
    kv_seg[:, :16] = 7  # no query is of document 7
    q_seg[:, 50:] = 9  # nor any key of document 9
    seg_t, seg_j = SegmentIds(*_t(q_seg, kv_seg)), tuple(_j(q_seg, kv_seg))
    got = flash_attention(*_t(q, k, v), bucket_size=bucket_size, segment_ids=seg_t)
    ref = jax_flash_attention(*_j(q, k, v), bucket_size=bucket_size, segment_ids=seg_j)
    _close(got, ref)


@pytest.mark.parametrize("path", ["flash", "cuda_plain", "ring_cuda"])
def test_cross_document_weights_exactly_zero(path):
    """Perturbing document 1's keys and values leaves every output row of
    documents 0 and 2 bit for bit the same."""
    q, k, v, _ = make_qkv(2)
    seg = make_seg(2, (0, 20, 44), 64)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 20:44] += 3.0
    v2[:, :, 20:44] -= 5.0

    def run(k, v):
        args = (*_t(q, k, v),)
        if path == "flash":
            return flash_attention(*args, causal=True, bucket_size=16,
                                   segment_ids=torch.from_numpy(seg))
        if path == "cuda_plain":
            return cuda_flash_attention(*args, causal=True,
                                        segment_ids=torch.from_numpy(seg))
        return ring_flash_attention(*args, None, VirtualRing(4), causal=True,
                                    impl="cuda", segment_ids=torch.from_numpy(seg))

    a, b = run(k, v), run(k2, v2)
    keep = np.r_[0:20, 44:64]
    assert torch.equal(a[:, :, keep], b[:, :, keep])
    assert not torch.equal(a[:, :, 20:44], b[:, :, 20:44])


def test_segment_ids_are_validated_naming_the_function():
    q, k, v, _ = make_qkv(0)
    x = _t(q, k, v)
    with pytest.raises(ValueError, match="flash_attention: q segment_ids must be"):
        flash_attention(*x, segment_ids=torch.zeros((2, 63), dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda_flash_attention: kv segment_ids must be int"):
        cuda_flash_attention(*x, segment_ids=(torch.zeros((2, 64), dtype=torch.int32),
                                              torch.zeros((2, 64))))
    with pytest.raises(ValueError, match="default_attention: q segment_ids"):
        default_attention(*x, segment_ids=torch.zeros((1, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="ring_flash_attention: segment_ids need equal"):
        ring_flash_attention(x[0], x[1][:, :, :32], x[2][:, :, :32], None, VirtualRing(2),
                             segment_ids=torch.zeros((2, 64), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@functools.cache
def _pallas_attention(name):
    q, k, v, do, seg, mask, kw = _case_inputs(name, seed=1)
    jmask = None if mask is None else jnp.asarray(mask)
    fn = lambda q, k, v: pallas_flash_attention(q, k, v, jmask, interpret=True,
                                                segment_ids=jnp.asarray(seg), **kw)
    out, vjp = jax.vjp(fn, *_j(q, k, v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("name", list(CASES))
def test_cuda_flash_attention_plain_matches_pallas(name):
    """B1 fused and B2/B3 through the custom gradient, plain on the CPU."""
    q, k, v, do, seg, mask, kw = _case_inputs(name, seed=1)
    ref, ref_grads = _pallas_attention(name)
    x = [a.requires_grad_() for a in _t(q, k, v)]
    out = cuda_flash_attention(*x, None if mask is None else torch.from_numpy(mask),
                               segment_ids=torch.from_numpy(seg), **kw)
    _close(out.detach(), ref)
    out.backward(torch.from_numpy(do))
    for a, g in zip(x, ref_grads):
        _close(a.grad, g, FLASH_GRAD_ATOL)


@pytest.mark.parametrize("softclamp", [None, 3.0])
def test_partials_modes_match_pallas(softclamp):
    """B1's seed, resume and fused-from-a-carry modes with ids: a hop chain
    over three key spans (the queries' ids against each span's own: the
    diagonal, then spans whose documents continue across the queries'
    boundaries, one ending in padding), GQA h4/hk2, a key mask on the last
    hop.  Every row meets a key of its document on the diagonal, so each
    hop's partials are defined the same way on both sides."""
    rng = np.random.default_rng(3)
    b, h, hk, n, d = 2, 4, 2, 64, 16
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    spans = [[rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2)]
             for _ in range(3)]
    mask = rng.random((b, n)) > 0.3
    q_seg = make_seg(b, (0, 10, 37), n) + 1
    kv_segs = [q_seg, make_seg(b, (0, 5, 50), n) + 1,
               make_seg(b, (0, 13, 40), n, pad_tail=7) + 2]
    kw = dict(scale=d ** -0.5, softclamp_value=softclamp)
    pkw = dict(kw, block_q=32, block_k=32, interpret=True)
    bands = (dict(causal_offset=0), dict(causal_offset=-1), dict())

    got = ref = None
    for i, ((k, v), kv_seg, band) in enumerate(zip(spans, kv_segs, bands)):
        tk, tv = _t(k, v)
        seg_t = dict(q_seg=torch.from_numpy(q_seg), kv_seg=torch.from_numpy(kv_seg))
        seg_j = tuple(_j(q_seg, kv_seg))
        if i < 2:
            got = cf.flash_partials(torch.from_numpy(q), tk, tv, carry=got, **band,
                                    **seg_t, **kw)
            ref = pallas_flash_partials(*_j(q, k, v), carry=ref, segment_ids=seg_j,
                                        **band, **pkw)
            for x, r in zip(got, ref):
                np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=ATOL)
        else:
            out, lse = cf.flash_fwd(torch.from_numpy(q), tk, tv, torch.from_numpy(mask),
                                    carry=got, **seg_t, **kw)
            jout, jlse = pallas_flash_fused(*_j(q, k, v, mask), carry=ref,
                                            segment_ids=seg_j, **pkw)
            _close(out, jout)
            np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("name", ["causal", "noncausal_kv_mask", "window", "softclamp"])
def test_backward_plain_matches_pallas_backward(name):
    """B2 and B3's plain version against ``pallas_flash_backward`` on the
    same (do, q, k, v, lse, delta), lse from the TPU forward."""
    q, k, v, do, seg, mask, kw = _case_inputs(name, seed=4)
    causal, window = kw.pop("causal"), kw.pop("window")
    band = dict(scale=q.shape[-1] ** -0.5, softclamp_value=kw["softclamp_value"],
                causal_offset=0 if causal else None,
                window_lo=None if window is None else -(window - 1))
    jmask = None if mask is None else jnp.asarray(mask)
    seg_j = (jnp.asarray(seg), jnp.asarray(seg))
    out, lse = pallas_flash_fused(*_j(q, k, v), jmask, segment_ids=seg_j,
                                  interpret=True, **band)
    delta = (jnp.asarray(do) * out).sum(-1)
    ref = pallas_flash_backward(jnp.asarray(do), *_j(q, k, v), lse, delta, jmask,
                                segment_ids=seg_j, interpret=True, **band)
    got = cf.flash_bwd(*_t(do, q, k, v, lse, delta),
                       None if mask is None else torch.from_numpy(mask),
                       q_seg=torch.from_numpy(seg), kv_seg=torch.from_numpy(seg), **band)
    for x, r in zip(got, ref):
        _close(x, r, FLASH_GRAD_ATOL)


def test_int8_sweep_takes_no_ids_yet():
    """The int8 sweep takes ids now (K3c); what it still refuses is a
    malformed pair, as the float sweep does."""
    q, k, v, _ = make_qkv(0)
    seg = torch.zeros((2, 64), dtype=torch.int32)
    out, _ = cf.flash_fwd(*_t(q, k, v), scale=0.25, compute_dtype="int8", q_seg=seg,
                          kv_seg=seg)
    ref, _ = cf.flash_fwd(*_t(q, k, v), scale=0.25, compute_dtype="int8")
    assert torch.equal(out, ref)  # one document: the unsegmented sweep
    with pytest.raises(ValueError, match="segment_ids"):
        cuda_flash_attention(*_t(q, k, v), compute_dtype="int8", segment_ids=seg[:, :7])


# ---------------------------------------------------------------------------
# the ring: VirtualRing vs the JAX ring under shard_map
# ---------------------------------------------------------------------------

# name: (ring size, striped, causal, window / max_ring_passes, bounds, pad
# tail); a PAD_SEGMENT_ID tail widens its shard's id range to every
# document, so the cases that must skip hops have none
RING_CASES = {
    "ring2_causal_pad_tail": (2, False, True, None, (0, 23, 48), 5),
    "ring4_causal": (4, False, True, None, (0, 10, 40), 0),
    "ring4_striped_pad_tail": (4, True, True, None, (0, 10, 40), 5),
    "ring4_noncausal": (4, False, False, None, (0, 7, 20, 33, 50), 0),
    "ring4_window_pad_tail": (4, False, True, (20, 3), (0, 10, 40), 5),
}


def _ring_inputs(name):
    ring_size, striped, causal, window, bounds, pad = RING_CASES[name]
    q, k, v, do = make_qkv(6)
    seg = make_seg(2, bounds, 64, pad_tail=pad)
    kw = dict(causal=causal, bucket_size=8)
    if window is not None:
        kw.update(window=window[0], max_ring_passes=window[1])
    return q, k, v, do, seg, ring_size, striped, kw


@functools.cache
def _jax_ring_case(name):
    q, k, v, do, seg, ring_size, striped, kw = _ring_inputs(name)
    mesh = jax_create_mesh(ring_size=ring_size, data_size=2,
                           devices=jax.devices()[:2 * ring_size])
    fn = partial(jax_ring, axis_name="seq", striped=striped, impl="xla", **kw)
    qspec = P("data", None, "seq", None)
    sharded = shard_map(lambda q, k, v, s: fn(q, k, v, None, segment_ids=s), mesh=mesh,
                        in_specs=(qspec, qspec, qspec, P("data", "seq")), out_specs=qspec)
    perm = ((lambda x, a=2: jsharding.stripe_permute(x, ring_size, axis=a)) if striped
            else (lambda x, a=2: x))
    unperm = ((lambda x: jsharding.stripe_unpermute(x, ring_size, axis=2)) if striped
              else (lambda x: x))
    jseg = perm(jnp.asarray(seg), 1)

    def run(q, k, v):
        return unperm(sharded(perm(q), perm(k), perm(v), jseg))

    out, vjp = jax.vjp(run, *_j(q, k, v))
    grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    # the (rank, hop) pairs whose band has work and whose ids skip them
    n_local = 64 // ring_size
    pseg = np.asarray(jseg)
    shard = lambda r: jnp.asarray(pseg[:, r * n_local:(r + 1) * n_local])
    passes = kw.get("max_ring_passes") or ring_size
    skips = 0
    for rank in range(ring_size):
        for i in range(passes):
            origin = (rank - i) % ring_size
            hi, lo = jring._hop_offsets(rank, origin, n_local, kw["causal"], striped,
                                        kw.get("window"), ring_size)
            band = bool(jring._hop_has_work(hi, lo, n_local, n_local))
            docs = bool(jring._hop_has_work(hi, lo, n_local, n_local, shard(rank),
                                            shard(origin)))
            skips += band and not docs
    return np.asarray(out), grads, skips


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_matches_jax_and_skips_its_hops(name, impl):
    q, k, v, do, seg, ring_size, striped, kw = _ring_inputs(name)
    ref, ref_grads, ref_skips = _jax_ring_case(name)
    perm = (lambda x, a=2: stripe_permute(x, ring_size, axis=a)) if striped else (lambda x, a=2: x)
    unperm = (lambda x: stripe_unpermute(x, ring_size, axis=2)) if striped else (lambda x: x)
    x = [a.requires_grad_() for a in _t(q, k, v)]
    pring.doc_skip_count = pring.doc_skip_bwd_count = 0
    out = unperm(ring_flash_attention(*(perm(a) for a in x), None, VirtualRing(ring_size),
                                      striped=striped, impl=impl,
                                      segment_ids=perm(torch.from_numpy(seg), 1), **kw))
    out.backward(torch.from_numpy(do))
    _close(out.detach(), ref)
    for a, g in zip(x, ref_grads):
        _close(a.grad, g, RING_GRAD_ATOL)
    assert (pring.doc_skip_count, pring.doc_skip_bwd_count) == (ref_skips, ref_skips)
    if name in ("ring4_causal", "ring4_noncausal"):
        assert ref_skips > 0  # the case must exercise the skip


def test_ring_cuda_skipped_hops_keep_the_launch_schedule(monkeypatch):
    """Contiguous causal ring of 4 whose ranks 2 and 3 share no document
    with the first two shards: hop 0 still seeds every rank, a skipped
    middle hop leaves the carry to the next hop with work, and a rank whose
    last hop is skipped finalizes on the host."""
    calls = []
    for name in ("flash_partials", "flash_fwd", "flash_bwd"):
        real = getattr(pring, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append((_name, kw.get("carry") is not None))
            return _real(*a, **kw)

        monkeypatch.setattr(pring, name, spy)
    q, k, v, _ = make_qkv(7, n=32)
    seg = make_seg(2, (0, 16), 32)  # ranks 0, 1: document 0; ranks 2, 3: document 1
    x = [a.requires_grad_() for a in _t(q, k, v)]
    out = ring_flash_attention(*x, None, VirtualRing(4), causal=True, impl="cuda",
                               segment_ids=torch.from_numpy(seg))
    out.sum().backward()
    # rank r has band work on hops 0..r (10 pairs); the ids drop rank 2's
    # hops 1 and 2 and rank 3's hops 2 and 3: 4 seeds, 2 resumes (ranks 1
    # and 3 at hop 1), no fused write from a carry (the one rank whose last
    # hop has band work, rank 3, skips it and finalizes on the host, as
    # ranks 0-2 do), 10 - 4 backward hops
    counts = (calls.count(("flash_partials", False)), calls.count(("flash_partials", True)),
              calls.count(("flash_fwd", True)), calls.count(("flash_bwd", False)))
    assert counts == (4, 2, 0, 6), counts
    ref = default_attention(*_t(q, k, v), causal=True, segment_ids=torch.from_numpy(seg))
    _close(out.detach(), ref)


def test_fused_ring_takes_no_ids_yet():
    """The fused ring takes ids (B7's segmented instantiation) and, since
    K4, its int8 feed with them; the counter-rotated schedule takes them
    on the scan ring (item 7e: the same output); what the fused ring still
    refuses with ids is that schedule, which has no fused form (a
    ValueError, as in JAX)."""
    q, k, v, _ = make_qkv(0)
    seg = torch.zeros((2, 64), dtype=torch.int32)
    kw = dict(impl="fused", compute_dtype="int8", segment_ids=seg)
    out = ring_flash_attention(*_t(q, k, v), None, VirtualRing(2), **kw)
    ref = ring_flash_attention(*_t(q, k, v), None, VirtualRing(2), **dict(kw, impl="cuda"))
    assert torch.equal(out, ref)
    counter = ring_flash_attention(*_t(q, k, v), None, VirtualRing(2), counter_rotate=True,
                                   **dict(kw, impl="cuda"))
    assert torch.equal(counter, ref)
    with pytest.raises(ValueError, match="counter-rotation"):
        ring_flash_attention(*_t(q, k, v), None, VirtualRing(2), counter_rotate=True, **kw)


# ---------------------------------------------------------------------------
# the models: RingAttention and RingTransformer vs the JAX models
# ---------------------------------------------------------------------------

LAYER = dict(dim=32, heads=4, dim_head=8, causal=True, bucket_size=8)
MODEL = dict(num_tokens=64, dim=32, depth=2, heads=4, kv_heads=2, dim_head=8,
             causal=True, bucket_size=8)


def _model_inputs(n=61):
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 64, (2, n)).astype(np.int32)
    seg = make_seg(2, (0, 25, 40), n)
    seg[1] = make_seg(1, (0, 7, 33), n, pad_tail=4)[0]
    return tokens, seg


@functools.cache
def _jax_layer(striped):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 61, 32)).astype(np.float32)
    _, seg = _model_inputs()
    local = JaxAttention(**LAYER)
    params = local.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sharded = JaxAttention(**LAYER, use_ring=True, auto_shard=True, striped=striped,
                           mesh=jax_create_mesh(ring_size=4, data_size=2))
    out = sharded.apply(params, jnp.asarray(x), None, jnp.asarray(seg))
    return x, jax.tree_util.tree_map(np.asarray, params), np.asarray(out)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("mesh", [None, "contiguous", "striped"])
def test_ring_attention_layer_matches_jax(mesh, impl):
    """The layer's local path and its auto-shard ring (61 tokens padded to
    64, the ids with ``PAD_SEGMENT_ID``) against the JAX ring layer."""
    x, params, ref = _jax_layer(mesh == "striped")
    _, seg = _model_inputs()
    ring = {} if mesh is None else dict(mesh=create_mesh(ring_size=4), auto_shard=True,
                                        striped=mesh == "striped")
    layer = RingAttention(**LAYER, impl=impl, device="cpu", **ring)
    state = params["params"]
    with torch.no_grad():
        layer.prenorm.gamma.copy_(torch.from_numpy(np.array(state["prenorm"]["gamma"])))
        layer.to_qkv.weight.copy_(torch.from_numpy(np.array(state["to_qkv"]["kernel"]).T))
        layer.to_out.weight.copy_(torch.from_numpy(np.array(state["to_out"]["kernel"]).T))
        out = layer(torch.from_numpy(x), None, torch.from_numpy(seg))
    _close(out, ref)


@functools.cache
def _jax_model(striped):
    jm = JaxTransformer(**MODEL, striped=striped,
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    tokens, seg = _model_inputs()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        p, jnp.asarray(tokens), return_loss=True, segment_ids=jnp.asarray(seg))))(params)
    logits = jm.apply(params, jnp.asarray(tokens), segment_ids=jnp.asarray(seg))
    return (jax.tree_util.tree_map(np.asarray, params), float(loss), grads,
            np.asarray(logits))


def _grads_as_jax(model):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return export_jax_params(holder)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("mesh", [None, "contiguous", "striped"])
def test_ring_transformer_packed_logits_loss_and_grads_match_jax(mesh, impl):
    params, ref_loss, ref_grads, ref_logits = _jax_model(mesh == "striped")
    tokens, seg = _model_inputs()
    ring = {} if mesh is None else dict(mesh=create_mesh(ring_size=4),
                                        striped=mesh == "striped")
    tm = load_jax_params(RingTransformer(**MODEL, impl=impl, device="cpu", **ring), params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg)), ref_logits,
               1e-4)
    loss = tm(torch.from_numpy(tokens), return_loss=True, segment_ids=torch.from_numpy(seg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(_grads_as_jax(tm)))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(r), err_msg=str(path),
                                   **MODEL_GRAD_TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_packed_loss_equals_separate_documents(impl):
    """``tests/test_segments.py:373`` on the port: two documents packed
    with ids give the loss of the same documents as separate ignore-padded
    rows (boundary label dropped), and the JAX package's packed loss."""
    model = RingTransformer(num_tokens=64, dim=32, depth=2, heads=4, dim_head=8,
                            causal=True, bucket_size=8, impl=impl, device="cpu")
    rng = np.random.default_rng(0)
    d1, d2 = rng.integers(0, 64, (1, 5)), rng.integers(0, 64, (1, 7))
    packed = torch.from_numpy(np.concatenate([d1, d2], axis=1))
    seg = torch.from_numpy(np.repeat([0, 1], [5, 7])[None, :])
    toks = np.full((2, 12), -1, np.int64)
    toks[0, :5], toks[1, :7] = d1, d2
    with torch.no_grad():
        packed_loss = model(packed, return_loss=True, segment_ids=seg)
        logits = model(torch.from_numpy(np.where(toks < 0, 0, toks))[:, :-1]).float()
    labels = torch.from_numpy(toks[:, 1:])
    valid = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp(min=0)[..., None])[..., 0]
    separate = (nll * valid).sum() / valid.sum()
    np.testing.assert_allclose(float(packed_loss), float(separate), atol=1e-5)

    jm = JaxTransformer(num_tokens=64, dim=32, depth=2, heads=4, dim_head=8,
                        causal=True, bucket_size=8, use_ring=False)
    jparams = export_jax_params(model)
    jloss = jm.apply(jparams, jnp.asarray(packed.numpy(), jnp.int32), return_loss=True,
                     segment_ids=jnp.asarray(seg.numpy()))
    np.testing.assert_allclose(float(packed_loss), float(jloss), rtol=1e-5)
