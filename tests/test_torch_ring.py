"""Parity: the port's ring vs the JAX ring on the 8-device CPU mesh.

The same numpy inputs go through ``ring_attention_tpu.parallel.
ring_flash_attention`` under ``shard_map`` (as ``tests/test_ring.py`` runs
it: ``impl="xla"``, and ``impl="pallas"`` in interpret mode for two cases)
and through the port's ``ring_flash_attention`` on a ``VirtualRing``, with
``impl="torch"``, ``impl="cuda"`` and ``impl="fused"`` (whose kernel
wrappers run their plain versions on CPU tensors).  Outputs to ``test_ring.py``'s ``ATOL = 2e-5``,
dq/dk/dv through ``jax.vjp`` to its ``GRAD_ATOL = 5e-4`` (float32 on both
sides).  Also: the hop arithmetic equals the JAX helpers exactly for every
(rank, hop); the plain partials chain equals the Pallas partials/resume/
fused kernels in interpret mode; the layout transforms equal JAX's.
"""

import functools
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.ops import pallas_flash as jpf
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring as jring
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.parallel import sharding as jsharding
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch.ops import cuda_flash as cf
from ring_attention_tpu_torch.ops.partials import (
    FlashPartials,
    finalize_partials,
    init_partials,
    merge_partials,
)
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    layout_permute,
    layout_unpermute,
    pad_seq_and_mask,
    ring_flash_attention,
    seq_world,
    stripe_permute,
    stripe_unpermute,
    validate_seq_len,
)
from ring_attention_tpu_torch.parallel import ring as pring

ATOL = 2e-5
GRAD_ATOL = 5e-4


# ---------------------------------------------------------------------------
# hop arithmetic
# ---------------------------------------------------------------------------

BANDS = {
    "full": (False, False, None),
    "causal": (True, False, None),
    "striped": (True, True, None),
    "window3": (True, False, 3),
    "window40": (True, False, 40),
    "striped_window3": (True, True, 3),
    "striped_window40": (True, True, 40),
}


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("ring_size", [1, 2, 4, 8])
def test_hop_helpers_equal_jax(ring_size, band):
    causal, striped, window = BANDS[band]
    n = 16
    geo = (n, causal, striped, window, ring_size)
    as_int = lambda x: None if x is None else int(x)  # noqa: E731
    # the unidirectional stream and the bidirectional half-streams
    for bidirectional in (False, True):
        streams = pring._streams(bidirectional, n)
        assert streams == jring._streams(bidirectional, n)
        for stream, i in ((s, i) for s in streams for i in range(ring_size)):
            assert pring._hop_is_full(stream, i, *geo) == jring._static_hop_band(
                stream, i, *geo)[0]
            for rank in range(ring_size):
                origin = (rank - stream[0] * i) % ring_size
                if stream[1] == 0:
                    hi, lo = pring._hop_offsets(rank, origin, *geo)
                    jhi, jlo = jring._hop_offsets(rank, origin, *geo)
                    assert (hi, lo) == (as_int(jhi), as_int(jlo)), (rank, i)
                hi, lo = pring._stream_offsets(stream, rank, i, *geo)
                jhi, jlo = jring._stream_offsets(stream, rank, i, *geo)
                assert (hi, lo) == (as_int(jhi), as_int(jlo)), (stream, rank, i)
                assert pring._hop_has_work(hi, lo, n, stream[2]) == bool(
                    jring._hop_has_work(jhi, jlo, n, stream[2])), (stream, rank, i)


def test_fit_bucket_equals_jax():
    for bucket, nk in ((8, 16), (16, 16), (512, 48), (7, 64)):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fitted = pring._fit_bucket(bucket, nk)
        with warnings.catch_warnings(record=True) as ref:
            warnings.simplefilter("always")
            assert fitted == jring._fit_bucket(bucket, nk)
        assert len(got) == len(ref)


# ---------------------------------------------------------------------------
# partials: plain chain vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


# (softclamp, n, the seed's band (causal offset, window_lo), the resume's
# causal offset, the Pallas blocks): the first two are the original cases;
# the rest put the seed and resume at the bf16 forward kernel's edges
# (ragged 128-row blocks, band edges inside a block and inside a 64-key
# tile), on the Pallas kernels' own blocks (32 does not divide 129 or 255)
CHAIN_CASES = {
    "None": (None, 64, (0, None), -1, 32),
    "3.0": (3.0, 64, (0, None), -1, 32),
    "ragged_nq129": (None, 129, (0, None), -1, None),
    "ragged_nq192": (None, 192, (0, None), -1, 32),
    "ragged_nq255_softclamp": (3.0, 255, (0, None), -1, None),
    "causal_edge_mid_block": (None, 192, (96, None), -20, 32),
    "window_edge_mid_block": (None, 192, (0, -70), -1, 32),
}


@functools.cache
def _pallas_chain(name):
    """The inputs of a chain case and the Pallas kernels' seed and resumed
    partials and fused output on them, computed once."""
    softclamp, n, (hi0, lo0), hi1, block = CHAIN_CASES[name]
    rng = np.random.default_rng(1)
    b, h, hk, d = 2, 4, 2, 16
    q = _np((b, h, n, d), rng)
    spans = [(_np((b, hk, n, d), rng), _np((b, hk, n, d), rng)) for _ in range(3)]
    mask = rng.random((b, n)) > 0.3
    kw = dict(scale=d ** -0.5, softclamp_value=softclamp)
    pkw = dict(kw, block_q=block, block_k=block, interpret=True)
    jnp_ = jnp.asarray
    seed = jpf.pallas_flash_partials(jnp_(q), jnp_(spans[0][0]), jnp_(spans[0][1]),
                                     causal_offset=hi0, window_lo=lo0, **pkw)
    resume = jpf.pallas_flash_partials(jnp_(q), jnp_(spans[1][0]), jnp_(spans[1][1]),
                                       causal_offset=hi1, carry=seed, **pkw)
    fused = jpf.pallas_flash_fused(jnp_(q), jnp_(spans[2][0]), jnp_(spans[2][1]),
                                   jnp_(mask), carry=resume, **pkw)
    as_np = lambda xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    return (q, spans, mask, kw, (hi0, lo0), hi1,
            (as_np(seed), as_np(resume), as_np(fused)))


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_partials_chain_equals_pallas(case):
    """Seed (diagonal), resume with a band-empty row 0 (striped hi = -1),
    fused from a carry under a key mask; GQA h4/hk2."""
    q, spans, mask, kw, (hi0, lo0), hi1, (ref_seed, ref_resume, ref_fused) = (
        _pallas_chain(case))
    t = torch.from_numpy

    got = cf.flash_partials(t(q), t(spans[0][0]), t(spans[0][1]),
                            causal_offset=hi0, window_lo=lo0, **kw)
    _assert_partials(got, ref_seed)

    got = cf.flash_partials(t(q), t(spans[1][0]), t(spans[1][1]),
                            causal_offset=hi1, carry=got, **kw)
    _assert_partials(got, ref_resume)

    out, lse = cf.flash_fwd(t(q), t(spans[2][0]), t(spans[2][1]), t(mask),
                            carry=got, **kw)
    jout, jlse = ref_fused
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=1e-6)


def test_flash_partials_out_is_explicit():
    """A resume writes over its carry only when asked to (``out=carry``),
    on every device; the CPU takes the plain version."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_np((1, 2, 16, 8), rng)) for _ in range(3))
    kw = dict(scale=8 ** -0.5, causal_offset=0)
    carry = cf.flash_partials(q, k, v, **kw)
    kept = FlashPartials(*(x.clone() for x in carry))
    got = cf.flash_partials(q, k, v, carry=carry, **kw)
    for x, y in zip(carry, kept):
        assert torch.equal(x, y)
    ref = cf.flash_partials_reference(q, k, v, carry=kept, **kw)
    inplace = cf.flash_partials(q, k, v, carry=carry, out=carry, **kw)
    for x, y, z, c in zip(got, ref, inplace, carry):
        assert torch.equal(x, y) and torch.equal(z, y)
        assert z is c


def _assert_partials(got, ref):
    for name, x, r in zip(("acc", "m", "l"), got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-5, atol=ATOL,
                                   err_msg=name)


def test_partials_ops_equal_jax():
    rng = np.random.default_rng(2)
    shape = (2, 3, 8)
    a = [_np(shape + (4,), rng), _np(shape, rng), np.abs(_np(shape, rng))]
    c = [_np(shape + (4,), rng), _np(shape, rng), np.abs(_np(shape, rng))]
    got = merge_partials(init_partials(2, 3, 8, 4), merge_partials(
        *(FlashPartials(*map(torch.from_numpy, x)) for x in (a, c))))
    ref = jpf.merge_partials(jpf.init_partials(2, 3, 8, 4), jpf.merge_partials(
        *(jpf.FlashPartials(*map(jnp.asarray, x)) for x in (a, c))))
    _assert_partials(got, ref)
    for x, r in zip(finalize_partials(got), jpf.finalize_partials(ref)):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# ring_flash_attention: VirtualRing vs the JAX ring under shard_map
# ---------------------------------------------------------------------------


def _jax_ring(q, k, v, mask, do, *, ring_size, striped, **kw):
    """Output and (dq, dk, dv) of the JAX ring on a (data, ring) mesh of
    the virtual CPU devices, in the natural sequence order."""
    data = 8 // ring_size if q.shape[0] % (8 // ring_size) == 0 else 1
    mesh = jax_create_mesh(ring_size=ring_size, data_size=data,
                           devices=jax.devices()[:ring_size * data])
    fn = partial(jax_ring, axis_name="seq", striped=striped, **kw)
    qspec, mspec = P("data", None, "seq", None), P("data", "seq")
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(qspec, qspec, qspec, mspec if mask is not None else P()),
        out_specs=qspec, check_vma=kw.get("impl", "xla") != "pallas",
    )
    perm = (lambda x: jsharding.stripe_permute(x, ring_size, axis=2)) if striped else (lambda x: x)
    unperm = (lambda x: jsharding.stripe_unpermute(x, ring_size, axis=2)) if striped else (lambda x: x)
    jmask = None if mask is None else jnp.asarray(mask)

    def run(q, k, v):
        return unperm(sharded(perm(q), perm(k), perm(v), jmask))

    out, vjp = jax.vjp(run, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(q, k, v, mask, do, *, ring_size, striped, **kw):
    ring = VirtualRing(ring_size)
    perm = (lambda x: stripe_permute(x, ring_size, axis=2)) if striped else (lambda x: x)
    unperm = (lambda x: stripe_unpermute(x, ring_size, axis=2)) if striped else (lambda x: x)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = unperm(ring_flash_attention(
        perm(qt), perm(kt), perm(vt),
        None if mask is None else torch.from_numpy(mask), ring,
        striped=striped, **kw,
    ))
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


# name: (ring_size, (b, h, hk, nq, nk, d), masked, ring kwargs)
RING_CASES = {
    "causal": (8, (2, 4, 4, 128, 128, 16), False, dict(causal=True)),
    "striped": (4, (2, 4, 4, 64, 64, 16), False, dict(causal=True, striped=True)),
    "full": (4, (2, 4, 4, 64, 64, 16), False, dict()),
    # window 20 over shards of 8: 3 passes of 8; the dk/dv catch-up rotation
    "window_limited_passes": (8, (2, 4, 4, 64, 64, 16), False,
                              dict(causal=True, window=20, max_ring_passes=4)),
    "striped_window": (4, (2, 4, 4, 64, 64, 16), False,
                       dict(causal=True, striped=True, window=11)),
    "kv_mask": (4, (2, 4, 4, 64, 64, 16), True, dict()),
    "gqa_h4_hk2": (4, (2, 4, 2, 64, 64, 16), False, dict(causal=True, striped=True)),
    "softclamp": (4, (2, 4, 4, 64, 64, 16), False, dict(causal=True, softclamp_value=2.0)),
    # unequal q and kv shards: each rank attends its local KV shard only
    "cross_attention": (4, (2, 4, 4, 64, 32, 16), True, dict()),
    "ring_of_one": (1, (2, 4, 2, 32, 32, 16), False, dict(causal=True)),
}


def _inputs(case, seed=0):
    ring_size, (b, h, hk, nq, nk, d), masked, kw = RING_CASES[case]
    rng = np.random.default_rng(seed)
    q, do = _np((b, h, nq, d), rng), _np((b, h, nq, d), rng)
    k, v = _np((b, hk, nk, d), rng), _np((b, hk, nk, d), rng)
    mask = None
    if masked:
        mask = rng.random((b, nk)) > 0.3
        mask[-1, : nk // ring_size] = False  # a shard with no valid key
    return q, k, v, mask, do, ring_size, kw


@functools.cache
def _jax_case(case):
    """The JAX ring's result for a case, shared by both port impls."""
    q, k, v, mask, do, ring_size, kw = _inputs(case)
    kw = dict(kw, bucket_size=8)
    striped = kw.pop("striped", False)
    return _jax_ring(q, k, v, mask, do, ring_size=ring_size, striped=striped,
                     impl="xla", **kw)


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_equals_jax(case, impl):
    q, k, v, mask, do, ring_size, kw = _inputs(case)
    kw = dict(kw, bucket_size=8)
    striped = kw.pop("striped", False)
    jout, jgrads = _jax_case(case)
    out, grads = _port_ring(q, k, v, mask, do, ring_size=ring_size,
                            striped=striped, impl=impl, **kw)
    np.testing.assert_allclose(out, jout, atol=ATOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["kv_mask", "striped"])
def test_ring_cuda_equals_pallas(case):
    """``impl="cuda"`` against the Pallas ring (interpret mode): the seed,
    resume and fused hops, and the per-hop backward kernels."""
    q, k, v, mask, do, ring_size, kw = _inputs(case, seed=3)
    striped = kw.pop("striped", False)
    jout, jgrads = _jax_ring(q, k, v, mask, do, ring_size=ring_size,
                             striped=striped, impl="pallas", bucket_size=16, **kw)
    out, grads = _port_ring(q, k, v, mask, do, ring_size=ring_size,
                            striped=striped, impl="cuda", **kw)
    np.testing.assert_allclose(out, jout, atol=ATOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_ATOL, err_msg=f"d{name}")


def test_cuda_ring_launch_schedule_on_cpu(monkeypatch):
    """The hop schedule of ``impl="cuda"`` at ring 4 (counted at the
    wrappers, which run their plain versions here): contiguous causal seeds
    4, resumes 5 and fuses 1 (ranks 0-2 finalize on the host); striped
    seeds 4, resumes 8 and fuses 4; the backward runs once per hop with
    work."""
    calls = []
    for name in ("flash_partials", "flash_fwd", "flash_bwd"):
        real = getattr(pring, name)

        def spy(*a, _name=name, _real=real, **kw):
            carry = kw.get("carry")
            calls.append((_name, carry is not None))
            return _real(*a, **kw)

        monkeypatch.setattr(pring, name, spy)
    rng = np.random.default_rng(4)
    x = [torch.from_numpy(_np((1, 2, 32, 16), rng)).requires_grad_() for _ in range(3)]
    for striped, expect in ((False, (4, 5, 1, 10)), (True, (4, 8, 4, 16))):
        calls.clear()
        out = ring_flash_attention(*x, None, VirtualRing(4), causal=True,
                                   striped=striped, impl="cuda")
        out.sum().backward()
        counts = (calls.count(("flash_partials", False)),
                  calls.count(("flash_partials", True)),
                  calls.count(("flash_fwd", True)),
                  calls.count(("flash_bwd", False)))
        assert counts == expect, (striped, counts)
        assert ("flash_fwd", False) not in calls


def test_ring_unported_options_raise():
    """The ring variants are ported (item 7e); what they still refuse is
    JAX's: counter-rotation on the fused kernels, the bidirectional ring on
    an odd shard (JAX asserts), a dk/dv dtype that is not floating, and a
    wire other than None and "int8"; bidirectional beside impl="fused" or
    counter_rotate warns and is dropped."""
    x = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="counter-rotation schedule has no fused form"):
        ring_flash_attention(x, x, x, None, VirtualRing(2), impl="fused", counter_rotate=True)
    odd = torch.zeros((1, 2, 10, 16))
    with pytest.raises(ValueError, match="bidirectional ring needs an even local sequence, got 5"):
        ring_flash_attention(odd, odd, odd, None, VirtualRing(2), bidirectional=True)
    # limited passes run one stream: an odd shard is no error there
    ring_flash_attention(odd, odd, odd, None, VirtualRing(2), bidirectional=True,
                         causal=True, max_ring_passes=1)
    with pytest.raises(ValueError, match="dkv_dtype='int8'"):
        ring_flash_attention(x, x, x, None, VirtualRing(2), dkv_dtype="int8")
    seg = torch.zeros((1, 8), dtype=torch.int32)
    for impl, kw in (("fused", dict(bidirectional=True)),
                     ("cuda", dict(bidirectional=True, counter_rotate=True))):
        with pytest.warns(UserWarning, match="ignoring bidirectional half-streams"):
            ring_flash_attention(x, x, x, None, VirtualRing(2), impl=impl, compute_dtype="int8",
                                 hop_compression="int8", segment_ids=seg, **kw)
    with pytest.raises(ValueError, match="hop_compression='fp8'"):
        ring_flash_attention(x, x, x, None, VirtualRing(2), hop_compression="fp8")
    with pytest.raises(ValueError, match="equal shards"):
        ring_flash_attention(x[:, :, :7], x[:, :, :7], x[:, :, :7], None, VirtualRing(2))


@pytest.mark.parametrize("impl,compute_dtype", [("torch", "int8"), ("cuda", "fp8")])
def test_ring_compute_dtype_validates(impl, compute_dtype):
    """compute_dtype is ported: "int8" off the kernels and values other
    than None/"int8" raise ValueError, as the JAX ring does."""
    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="compute_dtype"):
        ring_flash_attention(x, x, x, None, VirtualRing(2), impl=impl,
                             compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# layouts and the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring_size", [2, 4, 8])
def test_stripe_and_layout_equal_jax(ring_size):
    rng = np.random.default_rng(5)
    x = _np((2, 64, 3), rng)
    got = stripe_permute(torch.from_numpy(x), ring_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsharding.stripe_permute(jnp.asarray(x), ring_size)))
    np.testing.assert_array_equal(stripe_unpermute(got, ring_size).numpy(), x)
    for striped in (False, True):
        scheme, factor = jsharding.layout_for("ring", striped, ring_size, 1)
        from ring_attention_tpu_torch.parallel import layout_for

        assert layout_for("ring", striped, ring_size) == (scheme, factor)
        got = layout_permute(torch.from_numpy(x), scheme, factor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jsharding.layout_permute(jnp.asarray(x), scheme, factor)))
        np.testing.assert_array_equal(layout_unpermute(got, scheme, factor).numpy(), x)


@pytest.mark.parametrize("masked", [False, True])
def test_pad_seq_and_mask_equals_jax(masked):
    rng = np.random.default_rng(6)
    x = _np((2, 13, 4), rng)
    mask = rng.random((2, 13)) > 0.5 if masked else None
    got = pad_seq_and_mask(torch.from_numpy(x),
                           None if mask is None else torch.from_numpy(mask), 4)
    ref = jsharding.pad_seq_and_mask(jnp.asarray(x),
                                     None if mask is None else jnp.asarray(mask), 4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[2] == ref[2] == 13


def test_virtual_mesh():
    mesh = create_mesh(ring_size=4)
    assert mesh.shape == {"data": 1, "seq": 4} and seq_world(mesh) == 4
    assert mesh.ring.ranks == (0, 1, 2, 3)
    payloads = [(torch.tensor([r]),) for r in range(4)]
    assert [p[0].item() for p in mesh.ring.rotate(payloads, 1)] == [3, 0, 1, 2]
    validate_seq_len(64, mesh)
    with pytest.raises(ValueError, match="seq_len 30 % sequence world 4"):
        validate_seq_len(30, mesh)
    with pytest.raises(ValueError, match="needs torch.distributed"):
        create_mesh(ring_size=4, data_size=2)
