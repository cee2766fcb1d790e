"""Parity: the port's models on a ring mesh vs the JAX models on theirs.

The JAX ``RingTransformer`` runs on ``create_mesh(ring_size=4,
data_size=2)`` of the 8 virtual CPU devices; the port's on
``create_mesh(ring_size=4)``, a ``VirtualRing`` of 4 ranks in this process,
with the JAX weights (``load_jax_params``).  The sequence is odd (127
positions), so both pad at the model top; striped and contiguous layouts,
a lookback window that cuts the ring passes (the dk/dv catch-up rotation),
softclamp and GQA.  Loss and every parameter gradient, the three port
impls (the kernel wrappers of ``"cuda"`` and ``"fused"`` run their plain
versions on CPU tensors)
against the JAX ``impl="xla"`` model; three SGD steps of
``make_train_step`` against the JAX step on its mesh; the attention layer's
own pad -> stripe -> unpermute path with a key mask.  Tolerances are
``test_torch_train.py``'s: float32 on both sides, loss 1e-5 relative,
gradients 2e-5 absolute plus 1e-4 relative.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ring_attention_tpu.models import RingAttention as JaxAttention
from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.utils.train import make_train_step as jax_make_train_step
from ring_attention_tpu_torch import (
    RingAttention,
    RingTransformer,
    export_jax_params,
    load_jax_params,
    make_train_step,
)
from ring_attention_tpu_torch.parallel import (
    Mesh,
    Ring,
    create_mesh,
    stripe_permute,
    stripe_unpermute,
)

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2,
              dim_head=16, causal=True, bucket_size=16)
VARIANTS = {
    "contiguous": {},
    "striped": dict(striped=True),
    # layer 0 looks back 12 tokens: shards of 32 need 2 of the 4 passes
    "lookback_softclamp": dict(max_lookback_seq_len=(12, None), softclamp_value=4.0),
}


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_model(variant):
    jm = JaxTransformer(**CONFIG, **VARIANTS[variant],
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port_model(variant, impl, params):
    tm = RingTransformer(**CONFIG, **VARIANTS[variant], impl=impl, device="cpu",
                         mesh=create_mesh(ring_size=4))
    return load_jax_params(tm, params)


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
def _jax_loss_and_grads(variant):
    jm, params = _jax_model(variant)
    tokens = _tokens(1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(tokens), return_loss=True)))(params)
    return float(loss), grads


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ring_model_loss_and_grads_match_jax(variant, impl):
    _, params = _jax_model(variant)
    ref_loss, ref_grads = _jax_loss_and_grads(variant)
    tm = _port_model(variant, impl, params)
    loss = tm(torch.from_numpy(_tokens(1)), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    _assert_trees_close(_grads_as_jax(tm), ref_grads, **GRAD_TOL)


def test_ring_model_logits_match_local_model():
    """The ring changes where attention runs, not what the model computes:
    logits on the mesh equal the same weights' local model."""
    _, params = _jax_model("striped")
    tm = _port_model("striped", "cuda", params)
    local = load_jax_params(RingTransformer(**CONFIG, device="cpu"), params)
    tokens = torch.from_numpy(_tokens(2, n=127))
    with torch.no_grad():
        np.testing.assert_allclose(tm(tokens).numpy(), local(tokens).numpy(),
                                   atol=1e-4)


def test_ring_sgd_steps_match_jax_make_train_step():
    """Three SGD steps on the striped model: the port's step on the virtual
    ring and the JAX step on its mesh land on the same parameters."""
    jm, params = _jax_model("striped")
    tm = _port_model("striped", "cuda", params)
    lr = 0.5
    jstep = jax.jit(jax_make_train_step(
        lambda p, t: jm.apply(p, t, return_loss=True), optax.sgd(lr)))
    step = make_train_step(lambda t: tm(t, return_loss=True),
                           torch.optim.SGD(tm.parameters(), lr=lr))
    jparams, jstate = params, optax.sgd(lr).init(params)
    for seed in (3, 4, 5):
        tokens = _tokens(seed)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(tokens))
        np.testing.assert_allclose(float(step(torch.from_numpy(tokens))),
                                   float(jloss), rtol=1e-5)
    _assert_trees_close(export_jax_params(tm), jparams, **GRAD_TOL)


def test_ring_model_export_round_trips():
    _, params = _jax_model("contiguous")
    tm = _port_model("contiguous", "torch", params)
    exported = export_jax_params(tm)
    _assert_trees_close(exported, params, atol=0, rtol=0)
    again = load_jax_params(RingTransformer(**CONFIG, device="cpu",
                                            mesh=create_mesh(ring_size=4)), exported)
    for a, b in zip(again.parameters(), tm.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("striped", [False, True])
def test_ring_layer_auto_shard_matches_jax(striped):
    """The layer's own pad -> stripe -> ring -> unpermute path: non-causal,
    an odd sequence and a key mask (padding extends the mask)."""
    dim, n = 32, 29
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    mask = rng.random((2, n)) > 0.3
    jl = JaxAttention(dim=dim, heads=4, dim_head=8, kv_heads=2, striped=striped,
                      auto_shard=True, bucket_size=4,
                      mesh=jax_create_mesh(ring_size=4, data_size=2))
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))["params"]
    ref = jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tl = RingAttention(dim, heads=4, dim_head=8, kv_heads=2, striped=striped,
                       auto_shard=True, bucket_size=4, device="cpu",
                       mesh=create_mesh(ring_size=4))
    with torch.no_grad():
        tl.prenorm.gamma.copy_(torch.from_numpy(np.array(params["prenorm"]["gamma"])))
        tl.to_qkv.weight.copy_(torch.from_numpy(np.array(params["to_qkv"]["kernel"]).T))
        tl.to_out.weight.copy_(torch.from_numpy(np.array(params["to_out"]["kernel"]).T))
        out = tl(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


class _OneOfTwo(Ring):
    """A ring of which this process holds one rank of two."""

    world, ranks = 2, (0,)

    def rotate(self, payloads, shift):
        raise AssertionError("never reached")

    def all_gather(self, payloads, dim):
        raise AssertionError("never reached")

    def all_reduce(self, payloads, op):
        raise AssertionError("never reached")

    def all_to_all(self, payloads, split_dim, concat_dim):
        raise AssertionError("never reached")


# The model runs on a mesh whose ranks are processes
# (tests/test_torch_model_dist.py), Ulysses and hybrid included, and since
# items 7e and 6d with the ring variants and process-local batches
# (auto_shard=False); beside each, impl="auto" still raises, naming 7f
MULTIPROCESS_UNPORTED = {
    "ring_counter_rotate": (dict(ring_counter_rotate=True), "Port queue item 7f"),
    "process_local_batches": (dict(auto_shard=False), "Port queue item 7f"),
}


def test_model_on_a_multiprocess_mesh_raises():
    mesh = Mesh(data=1, seq=2, ring=_OneOfTwo())
    assert mesh.spans_processes
    for settings, item in MULTIPROCESS_UNPORTED.values():
        model = RingTransformer(**CONFIG, device="cpu", mesh=mesh, **settings)
        assert model.auto_shard == settings.get("auto_shard", True)
        assert model.attn_layers[0].ring_counter_rotate == settings.get(
            "ring_counter_rotate", False)
        with pytest.raises(NotImplementedError, match=item):
            RingTransformer(**CONFIG, device="cpu", mesh=mesh, impl="auto", **settings)
    # Ulysses builds on it; hybrid needs a factored one, where decoding
    # raises with JAX's words
    RingTransformer(**CONFIG, device="cpu", mesh=mesh, sequence_parallel="ulysses")
    with pytest.raises(ValueError, match="factored mesh"):
        RingTransformer(**CONFIG, device="cpu", mesh=mesh, sequence_parallel="hybrid")
    factored = Mesh(data=1, seq=4, ring=_OneOfTwo(), ulysses=2, ulysses_ring=_OneOfTwo())
    assert factored.spans_processes and factored.seq_ranks == (0,)
    model = RingTransformer(**CONFIG, device="cpu", mesh=factored, sequence_parallel="hybrid")
    with pytest.raises(NotImplementedError, match="factored hybrid mesh is a training/forward"):
        model.init_cache(2, 16)
    # a ring switched off would run the whole sequence on every process
    with pytest.raises(ValueError, match="use_ring=False or force_regular_attn"):
        RingTransformer(**CONFIG, device="cpu", mesh=mesh, use_ring=False)


@functools.cache
def _jax_ring_off(flag):
    jm = JaxTransformer(**CONFIG, **{flag: flag == "force_regular_attn"},
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    _, params = _jax_model("contiguous")
    tokens = jnp.asarray(_tokens(1))
    logits = jax.jit(lambda p: jm.apply(p, tokens[:, :127]))(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, tokens, return_loss=True)))(params)
    return np.asarray(logits), float(loss), grads


@pytest.mark.parametrize("flag", ["use_ring", "force_regular_attn"])
def test_ring_switched_off_matches_jax(flag):
    """``use_ring=False`` and ``force_regular_attn=True`` on a ring mesh run
    every layer locally (the latter on the dense ``default_attention``),
    as the JAX model does with the same field."""
    ref_logits, ref_loss, ref_grads = _jax_ring_off(flag)
    _, params = _jax_model("contiguous")
    tm = load_jax_params(RingTransformer(**CONFIG, device="cpu", mesh=create_mesh(ring_size=4),
                                         **{flag: flag == "force_regular_attn"}), params)
    assert all(layer._ring_world == 1 for layer in tm.attn_layers)
    tokens = torch.from_numpy(_tokens(1))
    with torch.no_grad():
        np.testing.assert_allclose(tm(tokens[:, :127]).numpy(), ref_logits, **GRAD_TOL)
    loss = tm(tokens, return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    _assert_trees_close(_grads_as_jax(tm), ref_grads, **GRAD_TOL)


def test_constructor_surface_of_the_jax_model():
    """``use_pallas`` selects ``impl`` when that is None; ``auto_shard=False``
    takes tokens padded and in the ring's layout in one process and returns
    logits in it; ``pallas_head_chunks`` raises one line, and an unknown
    ``remat_policy`` JAX's ``ValueError`` listing the valid names."""
    assert RingTransformer(**CONFIG, device="cpu", use_pallas=False).attn_layers[0].impl == "torch"
    assert RingTransformer(**CONFIG, device="cpu", use_pallas=True).attn_layers[0].impl == "cuda"
    assert RingAttention(32, device="cpu", impl="fused", use_pallas=False).impl == "fused"
    _, params = _jax_model("striped")
    mesh = create_mesh(ring_size=4)
    shard = _port_model("striped", "cuda", params)
    raw = load_jax_params(RingTransformer(**CONFIG, **VARIANTS["striped"], device="cpu",
                                          mesh=mesh, auto_shard=False), params)
    tokens = torch.from_numpy(_tokens(2))
    with torch.no_grad():
        np.testing.assert_array_equal(
            stripe_unpermute(raw(stripe_permute(tokens, 4)), 4).numpy(), shard(tokens).numpy())
    with pytest.raises(ValueError, match="no counterpart"):
        RingTransformer(**CONFIG, device="cpu", pallas_head_chunks=2)
    with pytest.raises(ValueError, match="no counterpart"):
        RingAttention(32, device="cpu", pallas_head_chunks=2)
    with pytest.raises(ValueError, match="unknown remat_policy 'dots'; valid policies: "
                       "checkpoint_dots, checkpoint_dots_no_batch, everything_saveable"):
        RingTransformer(**CONFIG, device="cpu", remat_policy="dots")
