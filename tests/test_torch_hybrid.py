"""Parity: the port's hybrid Ulysses x Ring strategy vs the JAX package's.

The port runs on ``create_mesh(ulysses_size=U, ring_size=R)`` in this
process (a ``VirtualRing(U)`` for the all-to-alls and a ``VirtualRing(R)``
for the outer ring, the U outer rings folded into the batch of one ring of
R), the JAX package on the factored meshes of its 8 virtual CPU devices.
The cases mirror ``tests/test_hybrid.py``: module parity on every factoring
of 4 and 8 ranks (odd length, auto-shard padding, contiguous and striped
at the outer degree), input gradients, parameter gradients, GQA (divisible,
small-hk, unaligned groups), the key mask with a masked tail, packed
segment ids, the lookback window in both layouts, the functional core, the
factored mesh's helpers, and the strategy / mesh mismatches.  As in JAX the
reference is the local dense layer (``use_ring=False,
force_regular_attn=True``) with the same weights, run by the JAX package;
the module parity also holds each port impl against the JAX hybrid module
itself on the (1, 2, 4) mesh.  The model: the hybrid ``RingTransformer``
(packed ids, striped) against the JAX hybrid model on its (2, 2, 2) mesh,
logits, loss and every gradient, the chunked loss against the dense one,
and the f32 int8 hybrid within the int8 bound of the JAX float model.
Pins: the outer ring's hops number R - 1 (the pure ring's W - 1), small-hk
K/V move once per ring chunk (two all-gathers, no all-to-all of repeated
heads), the outer ring refuses what the ring refuses (an odd chunk under
``bidirectional``, counter-rotation on the fused kernels), decoding on a
factored mesh raises with JAX's words.

Tolerances: outputs 2e-5 absolute, gradients 5e-4 absolute (JAX's ``ATOL``
and ``GRAD_ATOL``); the model's logits 1e-4 absolute, gradients
``GRAD_TOL`` (2e-5 absolute plus 1e-4 relative), loss 1e-5 relative; the
int8 hybrid's logits 2e-2 norm-relative (``Q8_FWD_REL_L2`` of
``tests/test_quant.py``).
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
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import hybrid_attention as jax_hybrid_attention
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import (
    RingAttention,
    RingTransformer,
    export_jax_params,
    load_jax_params,
)
from ring_attention_tpu_torch.ops import hybrid_positions
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    hybrid_attention,
    layout_for,
    seq_axes,
    seq_world,
)

ATOL = 2e-5
GRAD_ATOL = 5e-4
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
Q8_FWD_REL_L2 = 2e-2
# (ulysses, ring) factorings of the port's one-process mesh; the JAX
# oracle is the local layer, which no factoring changes
FACTORINGS = [(2, 2), (2, 4), (4, 2)]
LAYER = dict(dim=32, heads=8, dim_head=8, bucket_size=4)


def _fid(f):
    return "u{}xr{}".format(*f)


def _x(seed=0, n=31, dim=32):
    return np.random.default_rng(seed).standard_normal((2, n, dim)).astype(np.float32)


def _layer_kw(kw):
    return {**LAYER, **dict(kw)}


@functools.cache
def _jax_layer(kw, n=31, with_mask=False, with_seg=False, grads=None):
    """Params of the JAX layer (``LAYER`` plus ``kw``) and the local dense
    oracle's output on ``_x(n=n)`` (with a mask whose last 7 keys are off,
    or packed ids), and its gradients: ``"x"`` the input's, ``"params"``
    every parameter's, of ``(out ** 2).sum()``."""
    kw = _layer_kw(kw)
    dim = kw["dim"]
    x = jnp.asarray(_x(n=n, dim=dim))
    rng = np.random.default_rng(3)
    mask = jnp.asarray((rng.random((2, n)) > 0.3) & (np.arange(n) < n - 7)) if with_mask else None
    seg = jnp.asarray(np.sort(rng.integers(0, 4, (2, n)), axis=1).astype(np.int32)) \
        if with_seg else None
    ref = JaxAttention(use_ring=False, force_regular_attn=True,
                       **{k: v for k, v in kw.items() if k != "striped"})
    params = ref.init(jax.random.PRNGKey(0), x, mask)
    out = np.asarray(jax.jit(lambda p, x: ref.apply(p, x, mask, seg))(params, x))
    g = None
    if grads == "x":
        g = np.asarray(jax.jit(jax.grad(lambda x: (ref.apply(params, x, mask, seg) ** 2).sum()))(x))
    elif grads == "params":
        g = jax.jit(jax.grad(lambda p: (ref.apply(p, x, mask, seg) ** 2).sum()))(params)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, out, g, (None if mask is None else np.asarray(mask)), \
        (None if seg is None else np.asarray(seg))


def _port_layer(params, factoring, kw, impl="torch"):
    u, r = factoring
    layer = RingAttention(**_layer_kw(kw), impl=impl, auto_shard=True, device="cpu",
                          mesh=create_mesh(ring_size=r, ulysses_size=u),
                          sequence_parallel="hybrid")
    p = params["params"]
    with torch.no_grad():
        layer.prenorm.gamma.copy_(torch.from_numpy(np.array(p["prenorm"]["gamma"])))
        layer.to_qkv.weight.copy_(torch.from_numpy(np.array(p["to_qkv"]["kernel"]).T))
        layer.to_out.weight.copy_(torch.from_numpy(np.array(p["to_out"]["kernel"]).T))
    return layer


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("striped", [False, True])
@pytest.mark.parametrize("factoring", FACTORINGS, ids=_fid)
def test_hybrid_module_parity(factoring, striped, impl):
    """Causal parity on every factoring, odd length (auto-shard pad),
    striped (outer-ring stripe factor) and contiguous layouts."""
    kw = (("causal", True), ("striped", striped))
    params, ref, *_ = _jax_layer(kw)
    layer = _port_layer(params, factoring, dict(kw), impl)
    with torch.no_grad():
        out = layer(torch.from_numpy(_x()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@functools.cache
def _jax_hybrid_module(striped):
    """The JAX hybrid layer itself on the (1, 2, 4) mesh: its output."""
    kw = _layer_kw((("causal", True), ("striped", striped)))
    params, *_ = _jax_layer((("causal", True), ("striped", striped)))
    hyb = JaxAttention(use_ring=True, auto_shard=True, sequence_parallel="hybrid",
                       mesh=jax_create_mesh(ulysses_size=2, ring_size=4, data_size=1), **kw)
    return np.asarray(jax.jit(hyb.apply)(params, jnp.asarray(_x())))


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
@pytest.mark.parametrize("striped", [False, True])
def test_hybrid_module_matches_jax_hybrid(striped, impl):
    """Against the JAX hybrid layer on the same factoring (ulysses 2, ring
    4): ``"fused"`` takes the fused ring on the outer ring, as JAX's does."""
    kw = (("causal", True), ("striped", striped))
    params, *_ = _jax_layer(kw)
    layer = _port_layer(params, (2, 4), dict(kw), impl)
    with torch.no_grad():
        out = layer(torch.from_numpy(_x()))
    np.testing.assert_allclose(out.numpy(), _jax_hybrid_module(striped), atol=ATOL)


@pytest.mark.parametrize("factoring", FACTORINGS, ids=_fid)
def test_hybrid_input_grads(factoring):
    kw = (("causal", True), ("striped", True))
    params, _, ref, *_ = _jax_layer(kw, grads="x")
    layer = _port_layer(params, factoring, dict(kw), "cuda")
    x = torch.from_numpy(_x()).requires_grad_()
    (layer(x) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, atol=GRAD_ATOL)


def _param_grads_match(layer, ref):
    p = ref["params"]
    got = {"gamma": layer.prenorm.gamma.grad.numpy(),
           "to_qkv": layer.to_qkv.weight.grad.numpy().T,
           "to_out": layer.to_out.weight.grad.numpy().T}
    want = {"gamma": p["prenorm"]["gamma"], "to_qkv": p["to_qkv"]["kernel"],
            "to_out": p["to_out"]["kernel"]}
    for name in got:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=GRAD_ATOL,
                                   err_msg=name)


def test_hybrid_param_grads():
    """dk/dv sum back through the all-to-all's inverse and the ring's
    circulating dk/dv accumulators (ulysses 2, ring 4)."""
    kw = (("causal", True),)
    params, _, ref, *_ = _jax_layer(kw, n=32, grads="params")
    layer = _port_layer(params, (2, 4), dict(kw), "cuda")
    (layer(torch.from_numpy(_x(n=32))) ** 2).sum().backward()
    _param_grads_match(layer, ref)


def test_hybrid_gqa_divisible():
    """hk % ulysses == 0: the plain kv all-to-all leg."""
    kw = (("causal", True), ("kv_heads", 4), ("striped", True))
    params, ref, *_ = _jax_layer(kw)
    with torch.no_grad():
        out = _port_layer(params, (2, 2), dict(kw), "cuda")(torch.from_numpy(_x()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_hybrid_gqa_small_hk():
    """kv_heads < ulysses_size: the real heads move once (all-gather) and
    the ring circulates one head per rank; outputs and parameter gradients
    (summed over the copies) match."""
    kw = (("causal", True), ("kv_heads", 2), ("striped", True))
    params, ref, _, *_ = _jax_layer(kw)
    _, _, gref, *_ = _jax_layer(kw, grads="params")
    layer = _port_layer(params, (4, 2), dict(kw), "cuda")
    out = layer(torch.from_numpy(_x()))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    (out ** 2).sum().backward()
    _param_grads_match(layer, gref)


def test_hybrid_gqa_unaligned():
    """12 query heads over 3 kv heads on a 4-way ulysses group: one kv copy
    per local query head."""
    kw = (("causal", True), ("heads", 12), ("kv_heads", 3), ("dim", 48), ("dim_head", 4))
    params, ref, *_ = _jax_layer(kw)
    with torch.no_grad():
        out = _port_layer(params, (4, 2), dict(kw), "cuda")(torch.from_numpy(_x(dim=48)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
def test_hybrid_kv_mask_tail(impl):
    """Non-causal with a key mask whose last 7 keys are off: the mask is
    gathered over the ulysses group and rides the outer ring (``"fused"``:
    the local tier over the gathered span)."""
    kw = (("causal", False),)
    params, ref, _, mask, _ = _jax_layer(kw, with_mask=True)
    with torch.no_grad():
        out = _port_layer(params, (2, 4), dict(kw), impl)(torch.from_numpy(_x()), _t(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("factoring", [(2, 4), (4, 2)], ids=_fid)
def test_hybrid_packed_segments(factoring):
    """Packed ids survive the all-to-all and the per-hop kv-id circulation."""
    kw = (("causal", True), ("striped", True))
    params, ref, _, _, seg = _jax_layer(kw, with_seg=True)
    with torch.no_grad():
        out = _port_layer(params, factoring, dict(kw), "cuda")(torch.from_numpy(_x()),
                                                                None, _t(seg))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("striped", [False, True])
def test_hybrid_lookback_window(striped):
    """The window's offsets and hop skip derive from the OUTER ring's size
    and the ring chunk, exact in both layouts."""
    kw = (("causal", True), ("striped", striped), ("max_lookback_seq_len", 7))
    params, ref, *_ = _jax_layer(kw, n=32)
    with torch.no_grad():
        out = _port_layer(params, (2, 4), dict(kw), "cuda")(torch.from_numpy(_x(n=32)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_hybrid_bidirectional_raises():
    """JAX passes ``ring_bidirectional`` to the outer ring
    (``tests/test_hybrid.py::test_hybrid_bidirectional``), and so does the
    port since item 7e; what still raises there is the ring's own
    refusals: an odd outer-ring chunk under ``bidirectional`` and
    counter-rotation on the fused kernels.  A layer on an odd shard warns
    and runs unidirectional instead, as JAX's ``_bidirectional`` (on the
    plain ring here: a hybrid chunk of ``U * n_local`` is even at U = 2)."""
    q = torch.zeros(1, 8, 20, 4)
    with pytest.raises(ValueError, match="bidirectional ring needs an even local sequence"):
        hybrid_attention(q[:, :, :10], q[:, :, :10], q[:, :, :10], None, VirtualRing(1),
                         VirtualRing(2), bidirectional=True)
    with pytest.raises(ValueError, match="counter-rotation schedule has no fused form"):
        hybrid_attention(q, q, q, None, VirtualRing(2), VirtualRing(2), impl="fused",
                         counter_rotate=True)
    layer = RingAttention(**LAYER, causal=True, ring_bidirectional=True, device="cpu",
                          mesh=create_mesh(ring_size=2))
    with pytest.warns(UserWarning, match=r"per-device sequence length \(5\) is odd"):
        layer(torch.zeros(1, 10, LAYER["dim"]))


@functools.cache
def _jax_functional_core():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 8, 64, 16)).astype(np.float32) for _ in range(3))
    spec = P("data", None, ("ring", "ulysses"), None)
    out = shard_map(
        partial(jax_hybrid_attention, kv_mask=None, ulysses_axis="ulysses",
                ring_axis="ring", causal=True, bucket_size=8),
        mesh=jax_create_mesh(ulysses_size=2, ring_size=4, data_size=1),
        in_specs=(spec,) * 3, out_specs=spec,
    )(*map(jnp.asarray, (q, k, v)))
    ref = jax_default_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    return (q, k, v), np.asarray(out), np.asarray(ref)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_hybrid_functional_core(impl):
    (q, k, v), jax_out, ref = _jax_functional_core()
    out = hybrid_attention(*map(torch.from_numpy, (q, k, v)), None, VirtualRing(2),
                           VirtualRing(4), causal=True, bucket_size=8, impl=impl)
    np.testing.assert_allclose(out.numpy(), jax_out, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_hybrid_hop_count_and_kv_moves():
    """The outer ring of 4 hops 3 times a forward (each hop k and v), the
    pure ring of 8 seven: the ulysses degree fewer (JAX's HLO pin
    ``test_hybrid_hlo_hop_count``).  Small-hk GQA (hk 2 under 8 heads on
    ulysses 4) moves K/V once per ring chunk: two all-gathers, and only q
    and the output take the all-to-all (what the failing JAX audit
    ``test_ulysses_gqa_no_repeated_all_to_all`` means for the inner leg)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 64, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 8)).astype(np.float32))
            for _ in range(2))
    uring, ring = VirtualRing(2), VirtualRing(4)
    hybrid_attention(q, q, q, None, uring, ring, causal=True)
    assert ring.calls["rotate"] == 2 * (4 - 1)
    assert uring.calls["all_to_all"] == 4 * 4 and uring.calls["all_gather"] == 0
    from ring_attention_tpu_torch.parallel import ring_flash_attention
    pure = VirtualRing(8)
    ring_flash_attention(q, q, q, None, pure, causal=True)
    assert pure.calls["rotate"] == 2 * (8 - 1)
    uring, ring = VirtualRing(4), VirtualRing(2)
    hybrid_attention(q, k, v, None, uring, ring, causal=True)
    assert uring.calls["all_gather"] == 2 * 2 and uring.calls["all_to_all"] == 2 * 2
    assert ring.calls["rotate"] == 2 * (2 - 1)


def test_factored_mesh_helpers():
    mesh = create_mesh(ulysses_size=2, ring_size=4)
    assert seq_axes(mesh) == ("ring", "ulysses")
    assert seq_world(mesh) == 8
    assert mesh.shape == {"data": 1, "ring": 4, "ulysses": 2}
    assert mesh.seq_ranks == tuple(range(8)) and not mesh.spans_processes
    plain = create_mesh(ring_size=8)
    assert seq_axes(plain) == ("seq",)
    assert seq_world(plain) == 8
    assert layout_for("hybrid", True, 8, 2) == ("striped", 4)
    assert layout_for("ulysses", True, 8) == ("contiguous", 8)
    # hybrid positions: combined rank r * U + u, striped at the outer degree
    every = torch.cat([hybrid_positions(4, u, r, ulysses=2, ring=4, striped=False)
                       for r in range(4) for u in range(2)])
    assert torch.equal(every, torch.arange(32))
    striped = torch.cat([hybrid_positions(4, u, r, ulysses=2, ring=4, striped=True)
                         for r in range(4) for u in range(2)])
    assert torch.equal(striped.view(4, 8), torch.arange(32).view(8, 4).T)


def test_hybrid_requires_factored_mesh():
    """Hybrid on a plain mesh and a 1-D strategy on a factored one raise
    with JAX's words, at the layer and at the model; decoding on a factored
    mesh raises NotImplementedError as JAX's does."""
    with pytest.raises(ValueError, match="factored mesh"):
        RingAttention(**LAYER, causal=True, device="cpu", mesh=create_mesh(ring_size=8),
                      sequence_parallel="hybrid")
    with pytest.raises(ValueError, match="plain"):
        RingAttention(**LAYER, causal=True, device="cpu",
                      mesh=create_mesh(ulysses_size=2, ring_size=4), sequence_parallel="ring")
    model_kw = dict(num_tokens=64, dim=32, depth=1, heads=8, dim_head=4, causal=True,
                    striped=True, device="cpu")
    with pytest.raises(ValueError, match="factored mesh"):
        RingTransformer(**model_kw, mesh=create_mesh(ring_size=8), sequence_parallel="hybrid")
    model = RingTransformer(**model_kw, mesh=create_mesh(ulysses_size=2, ring_size=2),
                            sequence_parallel="hybrid")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for call in (lambda: model.init_cache(1, 16), lambda: model.generate(tokens, 16, 2),
                 lambda: model.attn_layers[0].decode_step(torch.zeros(1, 1, 32), None, None, 0)):
        with pytest.raises(NotImplementedError, match="factored hybrid mesh is a training"):
            call()


# --- the hybrid RingTransformer ----------------------------------------------

CONFIG = dict(num_tokens=64, dim=32, depth=2, heads=4, dim_head=8, causal=True,
              striped=True, bucket_size=4, sequence_parallel="hybrid")


def _model_inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, (2, 33)).astype(np.int32)
    seg = np.sort(rng.integers(0, 3, (2, 33)), axis=1).astype(np.int32)
    return tokens, seg


@functools.cache
def _jax_model():
    """The JAX hybrid model on its (2, 2, 2) mesh: params, logits, loss and
    gradients with packed ids."""
    jm = JaxTransformer(**CONFIG, mesh=jax_create_mesh(ulysses_size=2, ring_size=2,
                                                       data_size=2))
    tokens, seg = map(jnp.asarray, _model_inputs())
    params = JaxTransformer(**{k: v for k, v in CONFIG.items()
                               if k not in ("striped", "sequence_parallel")}).init(
        jax.random.PRNGKey(0), tokens)

    @jax.jit
    def run(p):
        logits = jm.apply(p, tokens[:, :-1], segment_ids=seg[:, :-1])
        return logits, jax.value_and_grad(
            lambda p: jm.apply(p, tokens, return_loss=True, segment_ids=seg))(p)

    logits, (loss, grads) = run(params)
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(logits), float(loss), grads


def _grads_as_jax(model):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return export_jax_params(holder)


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
def test_hybrid_model_matches_jax(impl):
    """The port's hybrid model (ulysses 2 x ring 2, striped, packed ids)
    against the JAX hybrid model on (data 2, ring 2, ulysses 2)."""
    params, ref_logits, ref_loss, ref_grads = _jax_model()
    tm = load_jax_params(RingTransformer(**CONFIG, impl=impl, device="cpu",
                                         mesh=create_mesh(ulysses_size=2, ring_size=2)), params)
    tokens, seg = map(torch.from_numpy, _model_inputs())
    with torch.no_grad():
        np.testing.assert_allclose(tm(tokens[:, :-1], segment_ids=seg[:, :-1]).numpy(),
                                   ref_logits, atol=1e-4)
    loss = tm(tokens, return_loss=True, segment_ids=seg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(_grads_as_jax(tm)))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(r), err_msg=str(path),
                                   **GRAD_TOL)


def test_hybrid_model_chunked_loss_and_int8():
    """The chunked loss on the factored striped layout equals the dense one
    (ulysses 2 x ring 4); the int8 hybrid (``compute_dtype="int8"`` with
    the int8 wire, passed to the outer ring) stays within the int8 bound of
    the JAX float model."""
    params, ref_logits, *_ = _jax_model()
    mesh = create_mesh(ulysses_size=2, ring_size=4)
    dense = load_jax_params(RingTransformer(**CONFIG, device="cpu", mesh=mesh), params)
    chunked = load_jax_params(RingTransformer(**CONFIG, device="cpu", mesh=mesh,
                                              loss_chunk_size=8), params)
    tokens, seg = map(torch.from_numpy, _model_inputs())
    with torch.no_grad():
        np.testing.assert_allclose(float(chunked(tokens, return_loss=True)),
                                   float(dense(tokens, return_loss=True)), atol=ATOL)
    int8 = load_jax_params(RingTransformer(**CONFIG, device="cpu", mesh=mesh, impl="cuda",
                                           compute_dtype="int8", ring_hop_compression="int8"),
                           params)
    with torch.no_grad():
        got = int8(tokens[:, :-1], segment_ids=seg[:, :-1]).numpy()
    rel = np.linalg.norm(got - ref_logits) / np.linalg.norm(ref_logits)
    assert rel <= Q8_FWD_REL_L2, rel
