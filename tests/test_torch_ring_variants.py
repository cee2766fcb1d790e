"""Parity: the ring variants (bidirectional half-streams, TokenRing
counter-rotation, ``dkv_dtype``), port vs JAX package, on the CPU.

The same numpy inputs go through ``ring_attention_tpu.parallel.
ring_flash_attention`` under ``shard_map`` on the 2 x 4 CPU mesh
(``impl="xla"``, and ``impl="pallas"`` in interpret mode for a few cases,
as ``tests/test_torch_ring.py`` runs it) and through the port's
``ring_flash_attention`` on a ``VirtualRing(4)`` with ``impl="torch"`` and
``impl="cuda"`` (whose kernel wrappers run their plain versions here).
Each JAX reference is computed once (``functools.cache``).  Tolerances are
``tests/test_ring.py``'s: output 2e-5, gradients 5e-4 absolute (float32 on
both sides); ``dkv_dtype="bfloat16"`` within JAX's 2e-2 bound
(``test_ring_dkv_bf16_circulation``), its dq bit for bit; the int8 counter
ring within ``test_torch_hop_compression.py``'s 1e-3 norm-relative (the
same int8 function on both sides).

Mirrored JAX tests: ``tests/test_ring.py:326-448`` (bidirectional),
``:450`` (dk/dv in bf16), ``:486-660`` (counter-rotation),
``tests/test_quant.py:305-322`` and ``tests/test_ring.py:762`` (the int8
counter ring), ``tests/test_attn_module.py:187-216``,
``tests/test_transformer.py:308`` and ``tests/test_hybrid.py:188`` (the
module and the model), ``tests/test_fuzz.py:267`` (half-stream bucket
fitting), ``analysis/contracts.py:80-99`` (the counter ring's rotation
counts).  The counter-rotated ring pairs the blocks of the
unidirectional ring's hops in the same order, so on the port it equals
that ring bit for bit; four gloo processes equal the ``VirtualRing``
bit for bit (``tests/torch_variants_dist_worker.py``).
"""

import copy
import functools
import multiprocessing
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.models import RingAttention as JaxAttention
from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring as jring
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.parallel import sharding as jsharding
from ring_attention_tpu.utils import resilience
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import (
    RingAttention,
    RingTransformer,
    export_jax_params,
    load_jax_params,
)
from ring_attention_tpu_torch.ops import quant
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    ring_flash_attention,
    stripe_permute,
    stripe_unpermute,
)
from ring_attention_tpu_torch.parallel import ring as pring

from torch_variants_dist_worker import JOIN_TIMEOUT_S, VARIANT_CASES, WORLD, run_variants

ATOL = 2e-5
GRAD_ATOL = 5e-4
DKV_BF16_TOL = 2e-2  # tests/test_ring.py::test_ring_dkv_bf16_circulation
OUT_REL_TOL = 1e-3  # tests/test_torch_hop_compression.py: the same int8 function
MODEL_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_ring_model.py
RING = 4

# name: (kv heads, key mask, ids, ring kwargs); b 2, h 4, n 64, d 16:
# shards of 16, half-streams of 8
CASES = {
    "causal": (4, False, False, dict(causal=True)),
    "striped": (4, False, False, dict(causal=True, striped=True)),
    "full": (4, False, False, dict()),
    "mask_gqa": (2, True, False, dict()),
    # window 20 over shards of 16: 3 passes, so the ring runs one stream and
    # the dk/dv catch-up rotation
    "window_limited_passes": (4, False, False, dict(causal=True, window=20,
                                                    max_ring_passes=3)),
    "striped_window": (4, False, False, dict(causal=True, striped=True, window=11)),
    "segments": (4, False, True, dict(causal=True)),
    "gqa_striped": (2, False, False, dict(causal=True, striped=True)),
}
# the Pallas references (interpret mode) at 32 tokens: shards of 8
PALLAS_N = 32
BIDIRECTIONAL = ["causal", "striped", "full", "mask_gqa", "window_limited_passes",
                 "striped_window"]
COUNTER = ["causal", "striped", "full", "mask_gqa", "window_limited_passes",
           "striped_window", "segments"]


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _inputs(case, seed=0, n=64):
    hk, masked, packed, kw = CASES[case]
    rng = np.random.default_rng(seed)
    q, do = _np((2, 4, n, 16), rng), _np((2, 4, n, 16), rng)
    k, v = _np((2, hk, n, 16), rng), _np((2, hk, n, 16), rng)
    mask = rng.random((2, n)) > 0.3 if masked else None
    ids = None
    if packed:  # three documents; rank 3's shard shares none with rank 0's
        ids = np.zeros((2, 64), np.int32)
        ids[:, 21:] = 1
        ids[:, 45:] = 2
    return q, k, v, mask, ids, do, dict(kw)


def _layout(striped, torch_side):
    if not striped:
        return (lambda x, a=2: x), (lambda x: x)
    if torch_side:
        return (lambda x, a=2: stripe_permute(x, RING, axis=a),
                lambda x: stripe_unpermute(x, RING, axis=2))
    return (lambda x, a=2: jsharding.stripe_permute(x, RING, axis=a),
            lambda x: jsharding.stripe_unpermute(x, RING, axis=2))


@functools.cache
def _jax(case, impl="xla", n=64, **knobs):
    """Output and (dq, dk, dv) of the JAX ring, in the natural order."""
    q, k, v, mask, ids, do, kw = _inputs(case, n=n)
    striped = kw.pop("striped", False)
    kw = dict(kw, **knobs)
    mesh = jax_create_mesh(ring_size=RING, data_size=2)
    fn = partial(jax_ring, axis_name="seq", bucket_size=8, impl=impl, striped=striped, **kw)
    qspec, sspec = P("data", None, "seq", None), P("data", "seq")
    sharded = shard_map(lambda q, k, v, m, s: fn(q, k, v, m, segment_ids=s), mesh=mesh,
                        in_specs=(qspec, qspec, qspec, sspec if mask is not None else P(),
                                  sspec if ids is not None else P()),
                        out_specs=qspec, check_vma=impl == "xla")
    perm, unperm = _layout(striped, torch_side=False)
    m = None if mask is None else perm(jnp.asarray(mask), 1)
    s = None if ids is None else perm(jnp.asarray(ids), 1)

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: unperm(sharded(perm(q), perm(k), perm(v), m, s)),
                           q, k, v)
        return out, vjp(do)

    out, grads = run(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(case, impl, n=64, **knobs):
    q, k, v, mask, ids, do, kw = _inputs(case, n=n)
    striped = kw.pop("striped", False)
    perm, unperm = _layout(striped, torch_side=True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = unperm(ring_flash_attention(
        perm(tq), perm(tk), perm(tv), None if mask is None else perm(torch.from_numpy(mask), 1),
        VirtualRing(RING), striped=striped, bucket_size=8, impl=impl,
        segment_ids=None if ids is None else perm(torch.from_numpy(ids), 1), **kw, **knobs))
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


def _assert_equal_jax(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL)
    for name, g, r in zip("qkv", got[1], ref[1]):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the half-streams' band arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["causal", "striped", "window_limited_passes",
                                  "striped_window"])
def test_stream_bands_equal_jax(case):
    """Every (stream, hop, rank): the shifted band, its work test and the
    ``full`` elision of both half-streams equal the JAX helpers."""
    kw = CASES[case][3]
    n_local = 16
    geo = (n_local, kw.get("causal", False), kw.get("striped", False), kw.get("window"), RING)
    for stream in pring._streams(True, n_local):
        for i in range(RING):
            assert pring._hop_is_full(stream, i, *geo) == jring._static_hop_band(
                stream, i, *geo)[0]
            for rank in range(RING):
                hi, lo = pring._stream_offsets(stream, rank, i, *geo)
                jhi, jlo = jring._stream_offsets(stream, rank, i, *geo)
                assert (hi, lo) == tuple(None if x is None else int(x) for x in (jhi, jlo))
                assert pring._hop_has_work(hi, lo, n_local, stream[2]) == bool(
                    jring._hop_has_work(jhi, jlo, n_local, stream[2]))


def test_counter_origins_equal_jax():
    for i in range(2 * RING):
        for rank in range(RING):
            assert pring._counter_origins(rank, i, RING) == tuple(
                int(x) for x in jring._counter_origins(rank, i, RING))
            q_origin, kv_origin = pring._counter_origins(rank, i, RING)
            assert (q_origin - kv_origin) % RING == i % RING


def test_counter_pack_round_trips_exactly():
    """bf16 queries and the f32 carry leave the ``[q | acc | m | l]`` pack
    as they entered it, bit for bit, contiguous."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(_np((2, 4, 8, 16), rng)).to(torch.bfloat16)
    acc, m, l = (torch.from_numpy(_np(s, rng)) for s in ((2, 4, 8, 16), (2, 4, 8), (2, 4, 8)))
    pack = pring._pack_counter(q, acc, m, l)
    assert pack.dtype == torch.float32 and pack.shape == (2, 4, 8, 34)
    np.testing.assert_array_equal(pack.numpy(), np.asarray(jring._pack_counter(
        jnp.asarray(q.float().numpy()), *map(jnp.asarray, (acc.numpy(), m.numpy(),
                                                            l.numpy())))))
    for got, want in zip(pring._unpack_counter(pack, 16, torch.bfloat16), (q, acc, m, l)):
        assert got.is_contiguous() and torch.equal(got, want)


# ---------------------------------------------------------------------------
# bidirectional half-streams (tests/test_ring.py:326-448)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", BIDIRECTIONAL)
def test_bidirectional_ring_equals_jax(case, impl):
    _assert_equal_jax(_port(case, impl, bidirectional=True), _jax(case, bidirectional=True))


def test_bidirectional_cuda_equals_pallas():
    """``impl="cuda"`` on the half-streams against the Pallas ring in
    interpret mode (``test_ring_bidirectional_pallas``: striped, GQA)."""
    _assert_equal_jax(_port("gqa_striped", "cuda", n=PALLAS_N, bidirectional=True),
                      _jax("gqa_striped", "pallas", n=PALLAS_N, bidirectional=True))


def test_bidirectional_launch_schedule_on_cpu(monkeypatch):
    """Contiguous causal ring of 4 on half-streams: 8 spans a rank, the
    first seeds, the last fuses where it has work; the forward stream's
    hops past the diagonal and the reverse stream's wrapped hops run
    unmasked (``full``); the backward runs once per span with work."""
    calls = []
    for name in ("flash_partials", "flash_fwd", "flash_bwd"):
        real = getattr(pring, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append((_name, kw.get("carry") is not None, kw.get("causal_offset")))
            return _real(*a, **kw)

        monkeypatch.setattr(pring, name, spy)
    x = [torch.zeros((1, 2, 32, 16), requires_grad=True) for _ in range(3)]
    ring_flash_attention(*x, None, VirtualRing(4), causal=True, impl="cuda",
                         bidirectional=True).sum().backward()
    kinds = [(n, c) for n, c, _ in calls]
    # spans with work: the forward stream's hop i on ranks >= i, the
    # reverse stream's hop 0 on every rank and hop i on ranks >= 4 - i
    assert kinds.count(("flash_partials", False)) == 4
    assert kinds.count(("flash_partials", True)) == 6 + 4 + 1 + 2
    assert kinds.count(("flash_fwd", True)) == 3  # rank 0 finalizes on the host
    assert ("flash_fwd", False) not in kinds
    assert kinds.count(("flash_bwd", False)) == 10 + 10
    unmasked = sum(o is None for n, _, o in calls if n != "flash_bwd")
    assert unmasked == 12  # 6 forward-stream hops past the diagonal, 6 wrapped


def test_bidirectional_odd_shard_warns_in_the_layer():
    """JAX ``_bidirectional``: an odd shard warns and runs unidirectional."""
    layer = RingAttention(dim=32, heads=4, dim_head=8, causal=True, bucket_size=8,
                          ring_bidirectional=True, device="cpu", mesh=create_mesh(ring_size=2))
    plain = RingAttention(dim=32, heads=4, dim_head=8, causal=True, bucket_size=8,
                          device="cpu", mesh=create_mesh(ring_size=2))
    plain.load_state_dict(layer.state_dict())
    x = torch.from_numpy(_np((1, 10, 32), np.random.default_rng(2)))
    with pytest.warns(UserWarning, match=r"per-device sequence length \(5\) is odd"):
        out = layer(x)
    with torch.no_grad():
        assert torch.equal(out, plain(x))


def test_half_stream_bucket_refit_warns_as_jax():
    """``tests/test_fuzz.py:267``: the bucket fits each half-stream; a fit
    to half the bucket or less warns, as JAX's ``_fit_bucket`` on the
    span it attends (shards of 16, bucket 16: halves of 8)."""
    x = torch.zeros((1, 2, 64, 8))
    for bidirectional, n_warn in ((False, 0), (True, 1)):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            ring_flash_attention(x, x, x, None, VirtualRing(4), causal=True, bucket_size=16,
                                 bidirectional=bidirectional)
        refits = [w for w in got if "refitted" in str(w.message)]
        with warnings.catch_warnings(record=True) as ref:
            warnings.simplefilter("always")
            jring._fit_bucket(16, jring._streams(bidirectional, 16)[0][2])
        assert len(refits) == len(ref) == n_warn
    # a bucket that divides the shard but not its half is refitted too
    # (n_local 12, bucket 4: halves of 6 take 3)
    y = torch.from_numpy(_np((1, 2, 48, 8), np.random.default_rng(3)))
    out = ring_flash_attention(y, y, y, None, VirtualRing(4), causal=True, bucket_size=4,
                               bidirectional=True)
    ref = ring_flash_attention(y, y, y, None, VirtualRing(4), causal=True, bucket_size=4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("compute", [None, "int8"])
def test_half_streams_quantize_once(compute):
    """The int8 wire's halves slice one quantization of the shard; under
    int8 compute each stream packs its own span (a feed blob cannot be
    sliced by token range): 4 and 8 quantizations a forward."""
    x = torch.from_numpy(_np((1, 2, 64, 16), np.random.default_rng(4)))
    quant.kv_quantize_count = 0
    with torch.no_grad():
        out = ring_flash_attention(x, x, x, None, VirtualRing(4), causal=True, bucket_size=8,
                                   impl="cuda", hop_compression="int8", compute_dtype=compute,
                                   bidirectional=True)
        ref = ring_flash_attention(x, x, x, None, VirtualRing(4), causal=True, bucket_size=8,
                                   impl="cuda", hop_compression="int8", compute_dtype=compute)
    assert quant.kv_quantize_count == (8 if compute else 4) + 4
    assert _rel(out, ref) <= (OUT_REL_TOL if compute else 1e-5)


# ---------------------------------------------------------------------------
# dk/dv in bf16 (tests/test_ring.py:450)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_dkv_bf16_circulation(impl):
    """dq never circulates: bit for bit the float32 ring's; dk/dv round to
    bf16 a hop, within JAX's bound of the float32 ring and of the JAX ring
    with the same accumulators."""
    out16, g16 = _port("causal", impl, dkv_dtype="bfloat16")
    out32, g32 = _port("causal", impl)
    np.testing.assert_array_equal(out16, out32)
    np.testing.assert_array_equal(g16[0], g32[0])
    _, jg = _jax("causal", dkv_dtype="bfloat16")
    for name, a, b, j in zip("kv", g16[1:], g32[1:], jg[1:]):
        np.testing.assert_allclose(a, b, atol=DKV_BF16_TOL, rtol=DKV_BF16_TOL,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(a, j, atol=DKV_BF16_TOL, rtol=DKV_BF16_TOL,
                                   err_msg=f"d{name}")
    with pytest.raises(ValueError, match="dkv_dtype='int8'"):
        _port("causal", impl, dkv_dtype="int8")


# ---------------------------------------------------------------------------
# counter-rotation (tests/test_ring.py:486-660)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", COUNTER)
def test_counter_ring_equals_jax(case, impl):
    got = _port(case, impl, counter_rotate=True)
    _assert_equal_jax(got, _jax(case, counter_rotate=True))
    # hop i pairs the unidirectional ring's blocks in its order: the same
    # launches on the same data
    plain = _port(case, impl)
    np.testing.assert_array_equal(got[0], plain[0])
    for g, p in zip(got[1], plain[1]):
        np.testing.assert_array_equal(g, p)


def test_counter_cuda_equals_pallas():
    """``tests/test_ring.py::test_ring_counter_pallas``: the hop chain of
    B1 modes on the travelling carry, against the Pallas counter ring in
    interpret mode."""
    _assert_equal_jax(_port("gqa_striped", "cuda", n=PALLAS_N, counter_rotate=True),
                      _jax("gqa_striped", "pallas", n=PALLAS_N, counter_rotate=True))


def test_counter_supersedes_bidirectional():
    with pytest.warns(UserWarning, match="ignoring bidirectional half-streams"):
        got = _port("striped", "cuda", counter_rotate=True, bidirectional=True)
    counter = _port("striped", "cuda", counter_rotate=True)
    np.testing.assert_array_equal(got[0], counter[0])


def test_counter_ring_dkv_dtype_is_ignored():
    """The counter backward keeps dk/dv on their rank: ``dkv_dtype`` does
    not enter it, as in JAX."""
    got = _port("causal", "cuda", counter_rotate=True, dkv_dtype="bfloat16")
    plain = _port("causal", "cuda", counter_rotate=True)
    for g, p in zip(got[1], plain[1]):
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("counter", [False, True], ids=["uni", "counter"])
def test_rotation_counts_equal_jax_contracts(counter):
    """``analysis/contracts.py:80-99``: on a ring of 4 the counter ring's
    forward takes ``ring`` rotations and a step ``2 * ring`` (the
    baseline: ``ring - 1`` and ``3 * ring - 2``); one per payload, as each
    is one JAX collective-permute (an int8 KV handle here, as JAX's
    ``counter_compressed`` row)."""
    ring = VirtualRing(RING)
    x = [torch.zeros((1, 2, 32, 16), requires_grad=True) for _ in range(3)]
    out = ring_flash_attention(*x, None, ring, causal=True, impl="cuda",
                               counter_rotate=counter, hop_compression="int8")
    assert ring.rotations == (RING if counter else RING - 1)
    out.sum().backward()
    assert ring.rotations == (2 * RING if counter else 3 * RING - 2)


# ---------------------------------------------------------------------------
# the int8 counter ring (tests/test_quant.py:305-322, tests/test_ring.py:762)
# ---------------------------------------------------------------------------


@functools.cache
def _jax_int8_counter():
    resilience.reset()
    return _jax("gqa_striped", "pallas", n=PALLAS_N, counter_rotate=True,
                hop_compression="int8", compute_dtype="int8")


@pytest.mark.parametrize("wire", [None, "int8"])
def test_int8_counter_ring_equals_jax(wire):
    """The counter schedule under int8 compute, with the int8 wire (JAX
    ``counter_q8``: B4 fed the payload's bytes) and without it (K/V
    quantized once per stream at the fitted block): the same int8 function
    as the JAX Pallas counter ring, output and gradients; and the
    unidirectional int8 ring's, bit for bit."""
    jout, jgrads = _jax_int8_counter()
    out, grads = _port("gqa_striped", "cuda", n=PALLAS_N, counter_rotate=True,
                       hop_compression=wire, compute_dtype="int8")
    assert _rel(out, jout) <= OUT_REL_TOL
    for g, r in zip(grads, jgrads):
        assert _rel(g, r) <= OUT_REL_TOL
    plain, _ = _port("gqa_striped", "cuda", n=PALLAS_N, hop_compression=wire,
                     compute_dtype="int8")
    np.testing.assert_array_equal(out, plain)


# ---------------------------------------------------------------------------
# the module and the model (tests/test_attn_module.py:187-216,
# tests/test_transformer.py:308, tests/test_hybrid.py:188)
# ---------------------------------------------------------------------------

MODEL = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
             causal=True, bucket_size=16, striped=True)
KNOBS = {
    "counter": dict(ring_counter_rotate=True),
    "bidirectional": dict(ring_bidirectional=True),
    "dkv_bf16": dict(ring_dkv_dtype="bfloat16"),
}


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _grads_as_jax(model):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return export_jax_params(holder)


def _assert_trees_close(got, ref, **tol):
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(r), err_msg=str(path), **tol)


@functools.cache
def _jax_params():
    params = JaxTransformer(**MODEL).init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    return jax.tree_util.tree_map(np.asarray, params)


@functools.cache
def _jax_model(knob):
    jm = JaxTransformer(**MODEL, **KNOBS[knob], mesh=jax_create_mesh(ring_size=RING,
                                                                     data_size=2))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(_tokens(1)), return_loss=True)))(_jax_params())
    return float(loss), grads


def _port_model(impl, **kw):
    return load_jax_params(RingTransformer(**MODEL, **kw, impl=impl, device="cpu",
                                           mesh=create_mesh(ring_size=RING)), _jax_params())


@pytest.mark.parametrize("knob,impl", [("counter", "torch"), ("counter", "cuda"),
                                       ("counter", "fused"), ("bidirectional", "torch"),
                                       ("bidirectional", "cuda"), ("dkv_bf16", "cuda")])
def test_model_variant_equals_jax(knob, impl):
    """``RingTransformer`` with each knob: loss and every parameter
    gradient against the JAX model with the same knob (``"fused"`` with
    counter-rotation runs the scan-path ring, JAX ``_kernel_impl``)."""
    ref_loss, ref_grads = _jax_model(knob)
    tm = _port_model(impl, **KNOBS[knob])
    if knob == "counter":
        assert all(layer._ring_impl == ("torch" if impl == "torch" else "cuda")
                   for layer in tm.attn_layers)
    loss = tm(torch.from_numpy(_tokens(1)), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    tol = dict(atol=3e-2, rtol=3e-2) if knob == "dkv_bf16" else MODEL_TOL  # test_transformer.py:322
    _assert_trees_close(_grads_as_jax(tm), ref_grads, **tol)


def test_counter_model_equals_the_ring_model_bit_for_bit():
    """The counter-rotated model computes what the unidirectional ring
    model does, launch for launch: logits, loss and gradients bit for
    bit."""
    tokens = torch.from_numpy(_tokens(1))
    results = []
    for kw in ({}, KNOBS["counter"]):
        tm = _port_model("cuda", **kw)
        with torch.no_grad():
            logits = tm(tokens[:, :127])
        loss = tm(tokens, return_loss=True)
        loss.backward()
        results.append([logits, loss.detach()] + [p.grad for p in tm.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


@functools.cache
def _jax_layer(knob, hybrid):
    mesh = (jax_create_mesh(ring_size=2, ulysses_size=2, data_size=2) if hybrid
            else jax_create_mesh(ring_size=RING, data_size=2))
    kw = dict(dim=32, heads=4, dim_head=8, causal=True, bucket_size=8, striped=True)
    ref = JaxAttention(**kw)
    x = jnp.asarray(_np((2, 32, 32), np.random.default_rng(5)))
    params = ref.init(jax.random.PRNGKey(0), x)
    layer = JaxAttention(**kw, **KNOBS[knob], use_ring=True, auto_shard=True, mesh=mesh,
                         sequence_parallel="hybrid" if hybrid else "ring")
    grad = jax.jit(jax.grad(lambda x: (layer.apply(params, x) ** 2).sum()))(x)
    return (jax.tree_util.tree_map(np.asarray, params), np.asarray(x),
            np.asarray(layer.apply(params, x)), np.asarray(grad))


@pytest.mark.parametrize("knob,hybrid", [("bidirectional", True)])
def test_layer_variant_equals_jax(knob, hybrid):
    """``RingAttention`` with a knob on the hybrid's outer ring
    (``tests/test_hybrid.py:188``): output and the input's gradient (the
    model tests above hold each knob on the ring)."""
    params, x, ref_out, ref_grad = _jax_layer(knob, hybrid)
    mesh = create_mesh(ring_size=2, ulysses_size=2) if hybrid else create_mesh(ring_size=RING)
    layer = RingAttention(dim=32, heads=4, dim_head=8, causal=True, bucket_size=8,
                          striped=True, **KNOBS[knob], impl="cuda", auto_shard=True,
                          mesh=mesh, sequence_parallel="hybrid" if hybrid else "ring",
                          device="cpu")
    p = params["params"]
    with torch.no_grad():
        layer.prenorm.gamma.copy_(torch.from_numpy(np.array(p["prenorm"]["gamma"])))
        layer.to_qkv.weight.copy_(torch.from_numpy(np.array(p["to_qkv"]["kernel"]).T))
        layer.to_out.weight.copy_(torch.from_numpy(np.array(p["to_out"]["kernel"]).T))
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    out = layer(tx)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), ref_grad, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# four gloo processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_variants")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_variants, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return {(name, r): dict(np.load(tmp / f"{name}_{r}.npz"))
            for name in VARIANT_CASES for r in range(WORLD)}


@pytest.mark.parametrize("name", list(VARIANT_CASES))
def test_variant_on_processes_equals_the_virtual_ring(dist_results, name):
    """Counter-rotation and the half-streams on four gloo processes: each
    process's output and gradients equal the ``VirtualRing``'s block for
    block, bit for bit (both sides one thread)."""
    from torch_variants_dist_worker import variant_case

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = variant_case(VirtualRing(WORLD), name)
    finally:
        torch.set_num_threads(threads)
    n_local = ref["out"].shape[2] // WORLD
    for r in range(WORLD):
        got = dist_results[name, r]
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_array_equal(got[key], ref[key][:, :, r * n_local:(r + 1) * n_local],
                                          err_msg=f"{key} rank {r}")
