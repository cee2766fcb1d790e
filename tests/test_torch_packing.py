"""Parity: declared document packings (``mask=``, ``doc_starts``) and the
fused ring's segment ids in the port vs the JAX package.

The same numpy inputs go through the JAX functions and their port, on the
CPU, where every kernel wrapper runs its plain version (the Pallas side in
interpret mode, at blocks that make the packings aligned for its tables):

- ``flash_fwd`` / ``flash_partials`` / ``flash_bwd`` with ``doc_starts``
  against ``pallas_flash_fused`` / ``pallas_flash_partials`` /
  ``pallas_flash_backward(doc_starts=)`` (aligned for both passes, for
  one, for none; windowed); ``cuda_flash_attention(doc_starts=)`` and its
  gradients against ``pallas_flash_attention(doc_starts=)``;
- ``attention(mask=...)`` under ``impl="cuda"`` and ``"torch"`` against
  the JAX ``attention(mask=..., impl="pallas", interpret=True)`` and
  ``impl="xla"``, and its errors against the JAX messages;
- ``fused_ring_local_plain`` with ids against the JAX
  ``fused_ring_local(q_segment_ids=, kv_segment_ids=)``; the fused ring
  with ids against the ``impl="cuda"`` ring bit for bit, with the hops the
  ids skip counted;
- ``RingAttention`` and ``RingTransformer(mask=...)`` (one mask, and one
  per layer) logits, loss and gradients against the JAX models with the
  same weights, locally and on ``VirtualRing(4)`` under ``impl="torch"``,
  ``"cuda"`` and ``"fused"``;
- where the two differ: a row whose document's keys are all masked (the
  kernels' visit sets), and the striped ring under a ``DocumentMask``.

Tolerances are the existing parity tests': outputs 2e-5
(``test_torch_ops.py``), flash gradients 5e-5 (``test_torch_flash_bwd.py``),
model logits 1e-4 and gradients 2e-5 absolute plus 1e-4 relative
(``test_torch_segments.py``); float32 on both sides.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu import masks as J
from ring_attention_tpu.models import RingAttention as JaxAttention
from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.ops import attention as jax_attention
from ring_attention_tpu.ops import pallas_ring as jpr
from ring_attention_tpu.ops.pallas_flash import (
    pallas_flash_attention,
    pallas_flash_backward,
    pallas_flash_fused,
    pallas_flash_partials,
)
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu_torch import (
    RingAttention,
    RingTransformer,
    cuda_flash_attention,
    export_jax_params,
    load_jax_params,
    masks as M,
)
from ring_attention_tpu_torch import ops
from ring_attention_tpu_torch.ops import cuda_flash as cf, cuda_ring
from ring_attention_tpu_torch.ops.attention import doc_runtime_ids
from ring_attention_tpu_torch.parallel import VirtualRing, create_mesh, ring_flash_attention
from ring_attention_tpu_torch.parallel import ring as pring

ATOL = 2e-5
FLASH_GRAD_ATOL = 5e-5
MODEL_GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, b=2, h=4, hk=2, n=128, d=16):
    rng = np.random.default_rng(seed)
    q, do = _np((b, h, n, d), rng), _np((b, h, n, d), rng)
    k, v = _np((b, hk, n, d), rng), _np((b, hk, n, d), rng)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, ref, atol=ATOL, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0,
                               err_msg=err)


# ---------------------------------------------------------------------------
# the kernels' plain versions vs the Pallas kernels, in interpret mode
# ---------------------------------------------------------------------------

# name: (doc_starts over 128 tokens, window); the Pallas side runs 32-row
# blocks (forward, dq) and 64-key blocks (dk/dv)
PACKINGS = {
    "aligned": ((0, 64), None),  # every table drops the other document's tiles
    "aligned_dq_only": ((0, 32, 96), None),  # the dk/dv pass runs runtime ids
    "misaligned": ((0, 23, 77), None),  # every pass runs runtime ids
    "windowed": ((0, 64), 20),
}


@pytest.mark.parametrize("name", list(PACKINGS))
def test_flash_kernels_with_doc_starts_match_pallas(name):
    starts, window = PACKINGS[name]
    q, k, v, do = _qkv(1)
    scale = 16 ** -0.5
    band = dict(scale=scale, causal_offset=0, window_lo=None if window is None else 1 - window)
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = cf.flash_fwd(tq, tk, tv, **band, doc_starts=starts)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    blocks = dict(block_q=32, block_k=32, interpret=True, doc_starts=starts)
    jout, jlse = pallas_flash_fused(jq, jk, jv, **band, **blocks)
    _close(out, jout, err="out")
    _close(lse, jlse, err="lse")
    parts = cf.flash_partials(tq, tk, tv, **band, doc_starts=starts)
    jparts = pallas_flash_partials(jq, jk, jv, **band, **blocks)
    for got, ref, what in zip(parts, jparts, ("acc", "m", "l")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=ATOL,
                                   err_msg=what)

    delta = (tdo * out).sum(-1)
    got = cf.flash_bwd(tdo, tq, tk, tv, lse, delta, **band, doc_starts=starts)
    ref = pallas_flash_backward(
        jdo, jq, jk, jv, jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()), **band,
        block_q_dq=32, block_k_dq=32, block_q_dkv=32, block_k_dkv=64, interpret=True,
        doc_starts=starts)
    for g, r, what in zip(got, ref, ("dq", "dk", "dv")):
        _close(g, r, FLASH_GRAD_ATOL, what)
    # the per-pass form: each pass alone gives the same as the pair
    dk, dv = cf.flash_bwd_dkv(tdo, tq, tk, tv, lse, delta, **band, doc_starts=starts)
    dq = cf.flash_bwd_dq(tdo, tq, tk, tv, lse, delta, **band, doc_starts=starts)
    for g, r in zip((dq, dk, dv), got):
        assert torch.equal(g, r)


@pytest.mark.parametrize("name", ["aligned", "windowed"])
def test_cuda_flash_attention_doc_starts_matches_pallas(name):
    starts, window = PACKINGS[name]
    q, k, v, do = _qkv(2)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = cuda_flash_attention(tq, tk, tv, causal=True, window=window, doc_starts=starts)
    out.backward(torch.from_numpy(do))

    def ref(q, k, v):
        return pallas_flash_attention(q, k, v, causal=True, window=window,
                                      doc_starts=starts, interpret=True)

    jout, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    _close(out.detach(), jout)
    for got, r, what in zip((tq, tk, tv), vjp(jnp.asarray(do)), ("dq", "dk", "dv")):
        _close(got.grad, r, FLASH_GRAD_ATOL, what)


def test_doc_starts_is_never_dropped():
    """Without tables the layout runs as runtime ids: the same function."""
    q, k, v, _ = _qkv(3)
    tq, tk, tv = _t(q, k, v)
    starts = (0, 23, 77)
    ids = doc_runtime_ids(starts, 128, 2)
    with torch.no_grad():
        ref = cuda_flash_attention(tq, tk, tv, causal=True, segment_ids=ids)
        for fn in (cuda_flash_attention, ops.flash_attention, ops.default_attention):
            assert torch.allclose(fn(tq, tk, tv, causal=True, doc_starts=starts), ref,
                                  atol=ATOL)
        noncausal = cuda_flash_attention(tq, tk, tv, doc_starts=starts)
        assert torch.allclose(noncausal, cuda_flash_attention(tq, tk, tv, segment_ids=ids),
                              atol=ATOL)
    with pytest.raises(ValueError, match="both declare the packing"):
        cuda_flash_attention(tq, tk, tv, causal=True, doc_starts=starts, segment_ids=ids)
    with pytest.raises(ValueError, match="doc_starts must be sorted unique offsets"):
        cuda_flash_attention(tq, tk, tv, causal=True, doc_starts=(0, 128))
    with torch.no_grad():  # and under int8 compute (K3c)
        assert torch.equal(
            cuda_flash_attention(tq, tk, tv, causal=True, doc_starts=starts,
                                 compute_dtype="int8"),
            cuda_flash_attention(tq, tk, tv, causal=True, segment_ids=ids,
                                 compute_dtype="int8"))


def test_an_empty_row_averages_what_each_side_visits():
    """A row whose document's keys are all masked (a key mask beside the
    causal band, at the kernel level: the entry points drop the key mask
    under causal) averages V over the keys it visits.  The port's plain
    version is dense: V over every key.  The JAX kernel's tables visit
    that row's document tiles at its own blocks (ROADMAP.md Queue 3)."""
    q, k, v, _ = _qkv(4, b=1, h=2, hk=2)
    starts = (0, 64)
    mask = np.ones((1, 128), bool)
    mask[0, 64:] = False  # the second document sees no key
    tq, tk, tv, tm = _t(q, k, v, mask)
    band = dict(scale=0.25, causal_offset=0)
    out, _ = cf.flash_fwd(tq, tk, tv, tm, **band, doc_starts=starts)
    jout, _ = pallas_flash_fused(*(jnp.asarray(x) for x in (q, k, v, mask)), **band,
                                 block_q=32, block_k=32, interpret=True, doc_starts=starts)
    jout = np.asarray(jout)
    _close(out[:, :, :64], jout[:, :, :64])
    _close(out[:, :, 64:], np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 2, 64, 16)))
    # JAX: rows 64..95 visit key tile 64..95, rows 96..127 tiles 64..127
    _close(jout[:, :, 64:96], np.broadcast_to(v[:, :, 64:96].mean(2, keepdims=True),
                                              (1, 2, 32, 16)))
    _close(jout[:, :, 96:], np.broadcast_to(v[:, :, 64:].mean(2, keepdims=True),
                                            (1, 2, 32, 16)))


# ---------------------------------------------------------------------------
# the entry point attention(mask=)
# ---------------------------------------------------------------------------

ENTRY_MASKS = {
    "docs": (lambda m: m.Causal() & m.DocumentMask((0, 40, 64)), None),
    "docs_window": (lambda m: m.Causal() & m.SlidingWindow(9) & m.DocumentMask((0, 64)), None),
    "segments": (lambda m: m.Causal() & m.Segments(), (0, 30, 100)),
    "window": (lambda m: m.Causal() & m.SlidingWindow(33), None),
}


@functools.cache
def _jax_entry(name, impl):
    build, seg_bounds = ENTRY_MASKS[name]
    q, k, v, _ = _qkv(5)
    seg = None if seg_bounds is None else doc_runtime_ids(seg_bounds, 128, 2).numpy()
    kw = dict(impl=impl, segment_ids=None if seg is None else jnp.asarray(seg))
    if impl == "pallas":
        kw["interpret"] = True
    return np.asarray(jax_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    mask=build(J), **kw))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("name", list(ENTRY_MASKS))
def test_attention_with_a_mask_matches_jax(name, impl):
    build, seg_bounds = ENTRY_MASKS[name]
    q, k, v, _ = _qkv(5)
    seg = None if seg_bounds is None else doc_runtime_ids(seg_bounds, 128, 2)
    with torch.no_grad():
        got = ops.attention(*_t(q, k, v), mask=build(M), impl=impl, segment_ids=seg)
    _close(got, _jax_entry(name, "pallas" if impl == "cuda" else "xla"))


def test_attention_errors_match_jax():
    q, k, v, _ = _qkv(6, n=64)
    jx, tx = [jnp.asarray(x) for x in (q, k, v)], _t(q, k, v)
    cases = [
        (dict(mask_fn=lambda m: m.Causal(), causal=True), ValueError),
        (dict(mask_fn=lambda m: m.Causal() & m.DocumentMask((0, 8)), doc_starts=(0, 8)),
         ValueError),
        (dict(mask_fn=lambda m: m.Causal() & m.Segments()), ValueError),
        (dict(mask_fn=lambda m: m.PrefixLM(4)), J.MaskLoweringError),
    ]
    for kw, exc in cases:
        build = kw.pop("mask_fn")
        with pytest.raises(exc) as ref:
            jax_attention(*jx, mask=build(J), impl="xla", **kw)
        with pytest.raises(exc if exc is ValueError else M.MaskLoweringError) as got:
            ops.attention(*tx, mask=build(M), impl="torch", **kw)
        assert str(got.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="Port queue item 7f"):
        ops.attention(*tx, mask=M.Causal(), impl="auto")
    with pytest.raises(ValueError, match="compute_dtype"):
        ops.attention(*tx, causal=True, impl="torch", compute_dtype="int8")


# ---------------------------------------------------------------------------
# the fused ring's segment ids (B7's plain version)
# ---------------------------------------------------------------------------

# name: (ring size, n_local, striped, window, document starts over the ring)
FUSED_CASES = {
    "contiguous": (4, 16, False, None, (0, 5, 30, 33, 60)),
    "striped": (4, 16, True, None, (0, 9, 40)),
    "window_gqa": (4, 16, False, 20, (0, 17, 18, 50)),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_ring_local_with_ids_matches_pallas(case):
    ring_size, n, striped, window, starts = FUSED_CASES[case]
    rng = np.random.default_rng(12)
    b, h, hk, d = 2, 4, 2 if window else 4, 16
    q = _np((b, h, ring_size * n, d), rng)
    k, v = _np((b, hk, ring_size * n, d), rng), _np((b, hk, ring_size * n, d), rng)
    ids = doc_runtime_ids(starts, ring_size * n, b).numpy()
    ids[1] = ids[1][::-1].copy()  # another packing in the second row
    kw = dict(n_local=n, scale=d ** -0.5)
    for rank in range(ring_size):
        geo = (rank, ring_size, n, True, striped, window, ring_size)
        tables = dict(zip(("origins", "his", "los", "works"), pring._fused_tables(*geo)))
        rows = slice(rank * n, (rank + 1) * n)
        qs = np.ascontiguousarray(ids[:, rows])
        out, lse = cuda_ring.fused_ring_local(
            torch.from_numpy(q[:, :, rows].copy()), *_t(k, v), **tables, **kw,
            q_seg=torch.from_numpy(qs), kv_seg=torch.from_numpy(ids))
        jout, jlse = jpr.fused_ring_local(
            jnp.asarray(q[:, :, rows]), jnp.asarray(k), jnp.asarray(v),
            **{name: jnp.asarray(t.numpy()) for name, t in tables.items()}, **kw,
            q_segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ids), interpret=True)
        _close(out, jout, err=f"out, rank {rank}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL, rtol=1e-6,
                                   err_msg=f"lse, rank {rank}")


@pytest.mark.parametrize("striped", [False, True])
def test_fused_ring_with_ids_equals_the_cuda_ring(striped):
    """The fused ring with ids runs B7 (its plain version here) over the
    gathered ids, never the remote tier; it visits the hops of the
    ``impl="cuda"`` chain, whose doc skips it counts, bit for bit."""
    q, k, v, do = _qkv(7, n=64)
    ids = doc_runtime_ids((0, 7, 20, 50), 64, 2)
    outs, grads, skips = {}, {}, {}
    for impl in ("cuda", "fused"):
        leaves = [x.requires_grad_() for x in _t(q, k, v)]
        pring.doc_skip_count = 0
        out = ring_flash_attention(*leaves, None, VirtualRing(4), causal=True,
                                   striped=striped, impl=impl, segment_ids=ids)
        skips[impl] = pring.doc_skip_count
        out.backward(torch.from_numpy(do))
        outs[impl], grads[impl] = out.detach(), [x.grad for x in leaves]
    assert torch.equal(outs["fused"], outs["cuda"])
    for a, b in zip(grads["fused"], grads["cuda"]):
        assert torch.equal(a, b)
    assert skips["fused"] == skips["cuda"] > 0


def test_fused_ring_with_ids_takes_the_local_tier(monkeypatch):
    calls = []
    for name in ("fused_ring_remote", "fused_ring_local"):
        real = getattr(pring, name)
        monkeypatch.setattr(pring, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    q, k, v, _ = _qkv(8, n=64)
    ring_flash_attention(*_t(q, k, v), None, VirtualRing(4), causal=True, impl="fused",
                         segment_ids=doc_runtime_ids((0, 30), 64, 2))
    assert calls == ["fused_ring_local"] * 4


# ---------------------------------------------------------------------------
# the models: RingAttention and RingTransformer with mask= vs the JAX models
# ---------------------------------------------------------------------------

STARTS = (0, 16, 40)  # 64 tokens; a ring of 4 holds shards of 16
MODEL = dict(num_tokens=64, dim=32, depth=2, heads=4, kv_heads=2, dim_head=8, bucket_size=8)


def _masks(m, per_layer):
    docs = m.Causal() & m.DocumentMask(STARTS)
    return (docs, m.Causal() & m.SlidingWindow(9)) if per_layer else docs


def _tokens():
    return np.random.default_rng(14).integers(0, 64, (2, 65)).astype(np.int32)


@functools.cache
def _jax_model(ring, per_layer):
    """The JAX model's params, logits on 64 tokens, loss and grads on 65
    (64 inputs: the packing holds for both)."""
    mesh = dict(mesh=jax_create_mesh(ring_size=4, data_size=2)) if ring else {}
    jm = JaxTransformer(**MODEL, mask=_masks(J, per_layer), **mesh)
    tokens = jnp.asarray(_tokens())
    params = jm.init(jax.random.PRNGKey(0), tokens[:, :64])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, tokens, return_loss=True)))(params)
    logits = jm.apply(params, tokens[:, :64])
    return (jax.tree_util.tree_map(np.asarray, params), np.asarray(logits), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


def _grads_as_jax(model):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return export_jax_params(holder)


# (where, impl, masks): every impl locally and on the ring with one mask; the
# per-layer masks locally and on the fused ring
MODEL_SETTINGS = [(w, i, "one_mask") for w in ("local", "ring") for i in ("torch", "cuda")]
MODEL_SETTINGS += [("ring", "fused", "one_mask"), ("local", "torch", "per_layer"),
                   ("local", "cuda", "per_layer"), ("ring", "fused", "per_layer")]


@pytest.mark.parametrize("where,impl,masks", MODEL_SETTINGS,
                         ids=["-".join(s) for s in MODEL_SETTINGS])
def test_ring_transformer_with_a_mask_matches_jax(where, impl, masks):
    per_layer = masks == "per_layer"
    params, ref_logits, ref_loss, ref_grads = _jax_model(where == "ring", per_layer)
    mesh = dict(mesh=create_mesh(ring_size=4)) if where == "ring" else {}
    tm = load_jax_params(RingTransformer(**MODEL, mask=_masks(M, per_layer), impl=impl,
                                         device="cpu", **mesh), params)
    tokens = torch.from_numpy(_tokens())
    with torch.no_grad():
        _close(tm(tokens[:, :64]), ref_logits, 1e-4)
    loss = tm(tokens, return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(_grads_as_jax(tm)))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], r, err_msg=str(path), **MODEL_GRAD_TOL)


def test_ring_attention_layer_with_a_mask_matches_jax():
    """The layer's local path and its auto-shard ring (61 tokens padded to
    64; the declared layout realized as ids before the padding) against
    the JAX layer."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 61, 32)).astype(np.float32)
    layer_kw = dict(dim=32, heads=4, dim_head=8, bucket_size=8)
    jm = J.Causal() & J.DocumentMask(STARTS)
    local = JaxAttention(**layer_kw, mask=jm)
    params = local.init(jax.random.PRNGKey(0), jnp.asarray(x))
    refs = {"local": local.apply(params, jnp.asarray(x))}
    sharded = JaxAttention(**layer_kw, mask=jm, use_ring=True, auto_shard=True,
                           mesh=jax_create_mesh(ring_size=4, data_size=2))
    refs["ring"] = sharded.apply(params, jnp.asarray(x))
    state = params["params"]
    for where, ref in refs.items():
        ring = dict(mesh=create_mesh(ring_size=4), auto_shard=True) if where == "ring" else {}
        layer = RingAttention(**layer_kw, mask=M.Causal() & M.DocumentMask(STARTS),
                              device="cpu", **ring)
        with torch.no_grad():
            layer.prenorm.gamma.copy_(torch.from_numpy(np.array(state["prenorm"]["gamma"])))
            layer.to_qkv.weight.copy_(torch.from_numpy(np.array(state["to_qkv"]["kernel"]).T))
            layer.to_out.weight.copy_(torch.from_numpy(np.array(state["to_out"]["kernel"]).T))
            _close(layer(torch.from_numpy(x)), ref, err=where)


def test_striped_ring_with_a_document_mask_equals_local():
    """JAX refuses a striped ring under a DocumentMask (its certificate has
    no striped lowering of the layout: MaskLoweringError); the port, which
    certifies no ring, runs the layout as ids in the striped order and
    gives the local model's logits (ROADMAP.md Queue 3)."""
    tokens = _tokens()[:, :64]
    jm = JaxTransformer(**MODEL, mask=_masks(J, False), striped=True,
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    with pytest.raises(J.MaskLoweringError, match="striped layouts lower band-shaped masks"):
        jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    local = RingTransformer(**MODEL, mask=_masks(M, False), device="cpu")
    striped = RingTransformer(**MODEL, mask=_masks(M, False), device="cpu", striped=True,
                              mesh=create_mesh(ring_size=4), impl="fused")
    striped.load_state_dict(local.state_dict())
    with torch.no_grad():
        _close(striped(torch.from_numpy(tokens)), local(torch.from_numpy(tokens)), 1e-5)


def test_model_mask_errors_match_jax():
    docs = M.Causal() & M.DocumentMask(STARTS)
    with pytest.raises(ValueError, match=r"mask= replaces causal=True"):
        RingTransformer(**MODEL, causal=True, mask=docs, device="cpu")
    with pytest.raises(ValueError, match="mask= replaces max_lookback_seq_len"):
        RingAttention(32, mask=docs, max_lookback_seq_len=4, device="cpu")
    with pytest.raises(ValueError, match="mask tuple has 1 entries for depth 2"):
        RingTransformer(**MODEL, mask=(docs,), device="cpu")
    with pytest.raises(M.MaskLoweringError, match="has no kernel lowering yet"):
        RingTransformer(**MODEL, mask=M.PrefixLM(3), device="cpu")
    with pytest.raises(ValueError, match="zigzag"):
        RingTransformer(**MODEL, mask=M.Full(), sequence_parallel="zigzag",
                        mesh=create_mesh(ring_size=2), device="cpu")
    model = RingTransformer(**MODEL, mask=docs, device="cpu")
    tokens = torch.from_numpy(_tokens()[:, :64])
    with pytest.raises(ValueError, match="declare one packing"):
        model(tokens, segment_ids=doc_runtime_ids(STARTS, 64, 2))
    seg_model = RingTransformer(**MODEL, mask=M.Causal() & M.Segments(), device="cpu")
    with pytest.raises(ValueError, match=r"the mask includes Segments\(\)"):
        seg_model(tokens)
    with torch.no_grad():
        assert torch.equal(seg_model(tokens, segment_ids=doc_runtime_ids(STARTS, 64, 2)),
                           seg_model(tokens, segment_ids=doc_runtime_ids(STARTS, 64, 2)))
