"""Parity: training the port's RingTransformer vs the JAX one on the CPU.

Weights come from the JAX ``RingTransformer.init`` (``load_jax_params``);
gradients and updated parameters come back in the flax layout
(``export_jax_params``) and are compared leaf by leaf.  ``impl="cuda"``
(whose kernel wrappers run their plain versions on CPU tensors) is held to
``use_pallas=True`` (the Pallas forward and both backward kernels in
interpret mode), ``impl="torch"`` to ``use_pallas=False``.
``make_train_step`` is held to the JAX ``make_train_step``: three SGD steps
on the model; Adam and AdamW on identical gradients against ``optax``;
gradient accumulation against one full batch; clipping against JAX's
formula; the guarded step's skip.  A bf16-compute model's gradients
reach every float32 parameter, and ``export_jax_params`` round-trips.
Tolerance: float32 on both sides.  Loss to 1e-5 relative; gradients to
2e-5 absolute plus 1e-4 relative (two layers and a 256-way projection,
sums in another order); parameters after three SGD steps likewise; Adam on
identical gradients to 1e-6 (one update of size ~lr).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.utils.train import make_train_step as jax_make_train_step
from ring_attention_tpu_torch import (
    RingTransformer,
    export_jax_params,
    init_step_stats,
    load_jax_params,
    make_train_step,
)

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2,
              dim_head=16, causal=True)
VARIANTS = {
    "plain": {},
    # layer 0 looks back 8 tokens, layer 1 attends globally; both softclamp
    "lookback_softclamp": dict(max_lookback_seq_len=(8, None), softclamp_value=4.0),
}
IMPLS = {"cuda": True, "torch": False}  # port impl -> JAX use_pallas


def _tokens(seed, b=2, n=33):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _pair(variant, impl):
    kw = dict(CONFIG, **VARIANTS[variant])
    jm = JaxTransformer(**kw, use_pallas=IMPLS[impl])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = RingTransformer(**kw, impl=impl, device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def _grads_as_jax(model):
    """The model's gradients in the flax layout."""
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


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax(variant, impl):
    jm, params, tm = _pair(variant, impl)
    tokens = _tokens(1)
    tokens[0, -1] = -1  # a label-only position: ignore_index drops it
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(tokens), return_loss=True)
    )(params)
    loss = tm(torch.from_numpy(tokens), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    _assert_trees_close(_grads_as_jax(tm), ref_grads, **GRAD_TOL)
    for p in tm.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


@pytest.mark.parametrize("impl", list(IMPLS))
def test_sgd_steps_match_jax_make_train_step(impl):
    """Three steps of plain SGD on one model: the port's step and the JAX
    step see the same batches and must land on the same parameters."""
    jm, params, tm = _pair("lookback_softclamp", impl)
    lr = 0.5
    jstep = jax.jit(jax_make_train_step(
        lambda p, t: jm.apply(p, t, return_loss=True), optax.sgd(lr)
    ))
    step = make_train_step(lambda t: tm(t, return_loss=True),
                           torch.optim.SGD(tm.parameters(), lr=lr))
    jparams, jstate = params, optax.sgd(lr).init(params)
    for seed in (2, 3, 4):
        tokens = _tokens(seed)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(tokens))
        loss = step(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(export_jax_params(tm), jparams, **GRAD_TOL)


def _fixed_gradient_problem(seed):
    """Parameters and a loss ``sum(p * g)`` whose gradient is exactly ``g``."""
    r = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}

    def torch_loss(scale=1.0):
        return sum((tparams[k] * tgrads[k]).sum() for k in tparams) * scale

    def jax_loss(p, scale=1.0):
        return sum((p[k] * grads[k]).sum() for k in p) * scale

    return params, tparams, torch_loss, jax_loss


OPTIMIZERS = {
    "adam": (lambda ps: torch.optim.Adam(ps, lr=1e-2), optax.adam(1e-2)),
    # optax decays by 1e-4 and torch by 1e-2 by default: pass it explicitly
    "adamw": (lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.1),
              optax.adamw(1e-2, weight_decay=0.1)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_adam_updates_match_optax_on_identical_gradients(name):
    """Adam's first steps are ~lr * sign(g), so model gradients that agree
    to 1e-7 could still flip an update where |g| is tiny; on identical
    gradients the port's step with torch.optim must match optax."""
    make_opt, jopt = OPTIMIZERS[name]
    params, tparams, torch_loss, jax_loss = _fixed_gradient_problem(0)
    step = make_train_step(torch_loss, make_opt(tparams.values()))
    jstep = jax_make_train_step(jax_loss, jopt)
    jparams, jstate = {k: jnp.asarray(v) for k, v in params.items()}, None
    jstate = jopt.init(jparams)
    for _ in range(3):
        step()
        jparams, jstate, _ = jstep(jparams, jstate)
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), atol=1e-6, rtol=0)


def test_clip_grad_norm_matches_jax_formula():
    """Clipping scales by ``min(1, c / max(norm, 1e-12))`` (no 1e-6 added
    to the norm, as ``torch.nn.utils.clip_grad_norm_`` does)."""
    params, tparams, torch_loss, jax_loss = _fixed_gradient_problem(1)
    for c in (0.5, 100.0):  # clipped, and left alone
        p0 = {k: v.detach().clone() for k, v in tparams.items()}
        step = make_train_step(torch_loss, torch.optim.SGD(tparams.values(), lr=1.0),
                               clip_grad_norm=c)
        jstep = jax_make_train_step(lambda p: jax_loss(p), optax.sgd(1.0),
                                    clip_grad_norm=c)
        jparams = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
        jparams, _, _ = jstep(jparams, optax.sgd(1.0).init(jparams))
        step()
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="clip_grad_norm must be > 0"):
        make_train_step(torch_loss, torch.optim.SGD(tparams.values(), lr=1.0),
                        clip_grad_norm=0.0)


def test_accum_steps_matches_one_full_batch():
    """Two microbatches of 2 rows, averaged in float32, give the update of
    one batch of 4 (every row has the same number of labels)."""
    _, _, tm_full = _pair("plain", "cuda")
    tm_acc = copy.deepcopy(tm_full)
    tokens = torch.from_numpy(_tokens(5, b=4))
    full = make_train_step(lambda t: tm_full(t, return_loss=True),
                           torch.optim.SGD(tm_full.parameters(), lr=0.5))
    acc = make_train_step(lambda t: tm_acc(t, return_loss=True),
                          torch.optim.SGD(tm_acc.parameters(), lr=0.5), accum_steps=2)
    np.testing.assert_allclose(float(acc(tokens)), float(full(tokens)), rtol=1e-5)
    _assert_trees_close(export_jax_params(tm_acc), export_jax_params(tm_full),
                        **GRAD_TOL)
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        make_train_step(lambda t: tm_acc(t, return_loss=True),
                        torch.optim.SGD(tm_acc.parameters(), lr=0.5),
                        accum_steps=3)(tokens)


def test_skip_nonfinite_leaves_params_and_state_bit_identical():
    params, tparams, torch_loss, _ = _fixed_gradient_problem(2)
    opt = torch.optim.Adam(tparams.values(), lr=1e-2)
    seen = []
    step = make_train_step(torch_loss, opt, skip_nonfinite=True,
                           on_step_end=seen.append)
    stats, loss = step(init_step_stats(), 1.0)  # a good step fills Adam's state
    assert stats.step_ok and stats.skipped == 0
    before = {k: v.detach().clone() for k, v in tparams.items()}
    state_before = copy.deepcopy(opt.state_dict())
    stats, loss = step(stats, float("nan"))  # a poisoned batch
    assert not stats.step_ok and stats.skipped == 1
    assert not np.isfinite(float(loss))  # the loss is reported, not masked
    for k in tparams:
        assert torch.equal(tparams[k].detach(), before[k])
    state_after = opt.state_dict()
    for i, s in state_before["state"].items():
        for key, value in s.items():
            assert torch.equal(state_after["state"][i][key], value)
    stats, _ = step(stats, 1.0)
    assert stats.step_ok and stats.skipped == 1
    assert not torch.equal(tparams["a"].detach(), before["a"])
    assert len(seen) == 3 and seen[1][0].skipped == 1


@pytest.mark.parametrize("impl", list(IMPLS))
def test_bf16_compute_backpropagates_into_f32_params(impl):
    """With a bf16 compute dtype the parameters stay float32 and every one
    of them (embedding, norms, projections, FFN, logits) gets a finite,
    nonzero float32 gradient through the attention backward."""
    tm = RingTransformer(**CONFIG, impl=impl, dtype=torch.bfloat16, device="cpu")
    load_jax_params(tm, _pair("plain", impl)[1])
    loss = tm(torch.from_numpy(_tokens(7)), return_loss=True)
    assert loss.dtype == torch.float32
    loss.backward()
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()) and p.grad.abs().max() > 0, name


def test_export_jax_params_round_trips_and_copies():
    """``export_jax_params`` is the inverse of ``load_jax_params`` (the
    exported tree equals the flax tree it was loaded from, leaf by leaf)
    and hands out copies that a later update does not change."""
    _, params, tm = _pair("plain", "torch")
    exported = export_jax_params(tm)
    _assert_trees_close(exported, params, atol=0, rtol=0)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    _assert_trees_close(exported, params, atol=0, rtol=0)
