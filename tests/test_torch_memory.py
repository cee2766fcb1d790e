"""Parity: the port's memory knobs against the JAX package.

The knobs change what a step keeps or how it cuts its work, never the
values: ``remat`` under each of the eight policies of the registry (and a
per-layer tuple), the blockwise FeedForward (``ff_chunk_size``), the
chunked loss (``loss_chunk_size``), the windowed decode cache and the
offloaded optimizer state.  Each is held to the JAX model without the knob
(``use_pallas=False``) on the same numpy inputs and weights
(``load_jax_params``): locally within the JAX tests' own tolerances
(``tests/test_memory.py:228-230``: loss 1e-6, gradients 1e-5, absolute),
on a ``VirtualRing`` of 4 within ``GRAD_TOL`` (the ring sums in hop spans:
``tests/test_torch_ring_model.py``'s tolerance).  The launch signature of
each policy is counted on the CPU path, where the kernel wrappers run their
plain versions: calls of ``flash_fwd_reference`` (B1's plain version) and
``flash_bwd_reference`` (B2 and B3's) per step.  The windowed cache is held
to the JAX model's own windowed decode.  The gloo processes' cases are in
``tests/torch_model_dist_worker.py`` (``remat_*``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.models.layers import FeedForward as JaxFeedForward
from ring_attention_tpu.models.remat import REMAT_POLICIES as JAX_POLICIES
from ring_attention_tpu.models.remat import resolve_remat_policy as jax_resolve_remat_policy
from ring_attention_tpu_torch import (
    RingTransformer,
    export_jax_params,
    load_jax_params,
    make_train_step,
)
from ring_attention_tpu_torch.models.layers import FeedForward
from ring_attention_tpu_torch.models.remat import REMAT_POLICIES, resolve_remat_policy
from ring_attention_tpu_torch.ops import cuda_flash, cuda_ring_remote, flash
from ring_attention_tpu_torch.parallel import create_mesh

LOSS_ATOL, GRAD_ATOL = 1e-6, 1e-5  # tests/test_memory.py:228-230
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_ring_model.py
DECODE_ATOL = 3e-5  # tests/test_decode.py ATOL
Q8_DECODE_ATOL = 1e-4  # tests/test_decode.py: the windowed int8 cache
CONFIG = dict(num_tokens=64, dim=32, depth=2, heads=4, kv_heads=2, dim_head=8,
              causal=True, bucket_size=8)
# test ids must be the same in every pytest-xdist worker: plain strings
POLICIES = {**{name: name for name in sorted(REMAT_POLICIES)},
            "None": None, "save_attn,None": ("save_attn", None)}
# B1's plain-version calls per step of the depth-2 model (its forward twice
# per layer where the backward reruns the attention); B2 and B3's: 2
B1_CALLS = {"nothing_saveable": 4, "None": 4, "checkpoint_dots": 4,
            "checkpoint_dots_no_batch": 4, "save_ffn_inputs": 4,
            "everything_saveable": 2, "save_attn": 2, "save_attn_and_ffn_inputs": 2,
            "offload_attn": 2, "save_attn,None": 3, "off": 2}


def _tokens(seed, b=2, n=33, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


def _ids(b=2, n=33, starts=(0, 9, 20)):
    ids = np.searchsorted(np.asarray(starts), np.arange(n), side="right") - 1
    return np.broadcast_to(ids.astype(np.int32), (b, n)).copy()


@functools.cache
def _jax_params():
    params = JaxTransformer(**CONFIG).init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    return jax.tree_util.tree_map(np.asarray, params)


@functools.cache
def _jax_reference(form="plain", n=33):
    """Loss and gradients of the JAX model without any knob, on the tokens
    (and ids or example mask) of ``form``."""
    kw = dict(ignore_index=5) if form == "ignore" else {}
    jm = JaxTransformer(**CONFIG, **kw)
    tokens = jnp.asarray(_tokens(1, n=n))
    extra = {}
    if form == "segments":
        extra["segment_ids"] = jnp.asarray(_ids(n=n))
    if form == "example_mask":
        extra["example_mask"] = jnp.asarray([True, False])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, tokens, return_loss=True, **extra)))(_jax_params())
    return float(loss), grads


def _port(**kw):
    return load_jax_params(RingTransformer(**{**CONFIG, **kw}, device="cpu"), _jax_params())


def _grads_as_jax(model):
    holder = _port()
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


def _loss_and_grads(model, form="plain", n=33):
    extra = {}
    if form == "segments":
        extra["segment_ids"] = torch.from_numpy(_ids(n=n)).long()
    if form == "example_mask":
        extra["example_mask"] = torch.tensor([True, False])
    loss = model(torch.from_numpy(_tokens(1, n=n)).long(), return_loss=True, **extra)
    loss.backward()
    return float(loss.detach()), _grads_as_jax(model)


def _hold_local(model, form="plain"):
    ref_loss, ref_grads = _jax_reference(form)
    loss, grads = _loss_and_grads(model, form)
    np.testing.assert_allclose(loss, ref_loss, atol=LOSS_ATOL)
    _assert_trees_close(grads, ref_grads, atol=GRAD_ATOL, rtol=0)


def _hold_ring(model):
    ref_loss, ref_grads = _jax_reference("plain", 128)
    loss, grads = _loss_and_grads(model, n=128)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    _assert_trees_close(grads, ref_grads, **GRAD_TOL)


class _Calls:
    """Counts calls of module attributes (the kernels' plain versions)."""

    def __init__(self, monkeypatch, **targets):
        self.counts = dict.fromkeys(targets, 0)
        for name, (module, attr) in targets.items():
            original = getattr(module, attr)

            def counted(*args, _name=name, _original=original, **kwargs):
                self.counts[_name] += 1
                return _original(*args, **kwargs)

            monkeypatch.setattr(module, attr, counted)


# ----------------------------------------------------------------------
# remat and its policy registry
# ----------------------------------------------------------------------


def test_registry_names_match_jax():
    assert set(REMAT_POLICIES) == set(JAX_POLICIES)
    assert resolve_remat_policy(None) is None
    assert resolve_remat_policy("offload_attn").offload


@pytest.mark.parametrize("name", list(POLICIES))
def test_remat_policy_matches_jax(name):
    """Each policy gives the JAX no-remat loss and gradients (JAX's own
    tolerances)."""
    _hold_local(_port(impl="cuda", remat=True, remat_policy=POLICIES[name]))


@pytest.mark.parametrize("name", list(B1_CALLS))
def test_remat_launch_signature(monkeypatch, name):
    """B1 runs twice per layer where the backward reruns the attention
    (None, nothing_saveable, the dot and FFN policies), once where the
    region keeps ``flash_out`` / ``flash_lse`` or keeps everything; B2 and B3
    once per layer always."""
    kw = {} if name == "off" else dict(remat=True, remat_policy=POLICIES[name])
    model = _port(impl="cuda", **kw)
    calls = _Calls(monkeypatch, fwd=(cuda_flash, "flash_fwd_reference"),
                   bwd=(cuda_flash, "flash_bwd_reference"))
    _loss_and_grads(model)
    assert calls.counts == {"fwd": B1_CALLS[name], "bwd": 2}, calls.counts


@pytest.mark.parametrize("name", ["save_attn", "nothing_saveable", "offload_attn"])
def test_remat_on_the_blockwise_path(monkeypatch, name):
    """``impl="torch"``: the blockwise core keeps its pair under the
    ``save_attn`` family (one sweep per layer and step) and reruns under
    ``nothing_saveable`` (two)."""
    model = _port(impl="torch", remat=True, remat_policy=name)
    calls = _Calls(monkeypatch, sweep=(flash, "attend_blocks"))
    _hold_local(model)
    assert calls.counts["sweep"] == (4 if name == "nothing_saveable" else 2)


def _validation_cases():
    return {
        "unknown_name": dict(remat=True, remat_policy="bogus"),
        "unknown_in_tuple": dict(remat=True, remat_policy=("save_attn", "dots")),
        "tuple_length": dict(remat=True, remat_policy=("save_attn",) * 3),
        "ff_chunk_zero": dict(ff_chunk_size=0),
        "ff_chunk_negative": dict(ff_chunk_size=-3),
        "loss_chunk_zero": dict(loss_chunk_size=0),
    }


@pytest.mark.parametrize("case", list(_validation_cases()))
def test_validation_messages_match_jax(case):
    kw = _validation_cases()[case]
    with pytest.raises(ValueError) as jax_err:
        JaxTransformer(**CONFIG, **kw).init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    with pytest.raises(ValueError) as err:
        RingTransformer(**CONFIG, **kw, device="cpu")
    assert str(err.value) == str(jax_err.value)


def test_resolve_unknown_policy_matches_jax():
    with pytest.raises(ValueError) as jax_err:
        jax_resolve_remat_policy("nope")
    with pytest.raises(ValueError) as err:
        resolve_remat_policy("nope")
    assert str(err.value) == str(jax_err.value)
    assert "offload_attn" in str(err.value) and "valid policies" in str(err.value)


def test_int8_remat_equals_int8_without_remat():
    """``compute_dtype="int8"`` (the int8 sweep, B4's plain version) under
    ``save_attn`` and ``nothing_saveable``: the loss and gradients of the
    int8 model without remat, bit for bit."""
    want = _loss_and_grads(_port(compute_dtype="int8"))
    for policy in ("save_attn", "nothing_saveable"):
        got = _loss_and_grads(_port(compute_dtype="int8", remat=True, remat_policy=policy))
        assert got[0] == want[0]
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got[1]),
                                     jax.tree_util.tree_leaves_with_path(want[1])):
            np.testing.assert_array_equal(g, w, err_msg=f"{policy} {path}")


# every knob together on a ring of 4: name -> model settings
RING_CASES = {
    "cuda_striped_save_attn": dict(impl="cuda", striped=True, remat=True,
                                   remat_policy="save_attn", ff_chunk_size=8,
                                   loss_chunk_size=24),
    "cuda_nothing_saveable": dict(impl="cuda", remat=True, remat_policy="nothing_saveable",
                                  ff_chunk_size=12),
    "torch_offload_attn": dict(impl="torch", striped=True, remat=True,
                               remat_policy="offload_attn", loss_chunk_size=40),
    "fused_save_attn": dict(impl="fused", remat=True, remat_policy="save_attn",
                            ff_chunk_size=5, loss_chunk_size=24),
    "fused_striped_dots": dict(impl="fused", striped=True, remat=True,
                               remat_policy="checkpoint_dots"),
    "zigzag_save_attn": dict(impl="cuda", sequence_parallel="zigzag", remat=True,
                             remat_policy=("save_attn", "save_ffn_inputs"),
                             ff_chunk_size=7, loss_chunk_size=50),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_memory_knobs_match_jax(case):
    """The knobs on a ``VirtualRing`` of 4 (127 positions, padded to the
    ring): the JAX loss and gradients."""
    _hold_ring(_port(mesh=create_mesh(ring_size=4), **RING_CASES[case]))


@pytest.mark.parametrize("impl", ["cuda", "fused"])
def test_ring_launches_under_remat(monkeypatch, impl):
    """On the scan ring the seed, resume and fused-carry launches (their
    plain versions) halve from ``None`` to ``save_attn``, which runs the
    forward once as without remat; the fused ring tags nothing and reruns
    (JAX ``ops/pallas_ring.py``)."""
    targets = {"cuda": dict(fwd=(cuda_flash, "flash_fwd_reference"),
                            partials=(cuda_flash, "flash_partials_reference")),
               "fused": dict(ring=(cuda_ring_remote, "fused_ring_remote_plain"))}[impl]
    counts = {}
    for policy in ("off", None, "save_attn"):
        kw = {} if policy == "off" else dict(remat=True, remat_policy=policy)
        model = _port(mesh=create_mesh(ring_size=4), impl=impl, **kw)
        calls = _Calls(monkeypatch, **targets)
        model(torch.from_numpy(_tokens(1, n=128)).long(), return_loss=True).backward()
        counts[policy] = dict(calls.counts)
        monkeypatch.undo()
    doubled = {k: 2 * v for k, v in counts["off"].items()}
    if impl == "cuda":
        assert counts[None] == doubled and counts["save_attn"] == counts["off"], counts
    else:
        assert counts[None] == counts["save_attn"] == doubled, counts
    assert all(v > 0 for v in counts["off"].values()), counts


# ----------------------------------------------------------------------
# the blockwise FeedForward
# ----------------------------------------------------------------------

# name: (n, chunk, seq_shards)
FF_CASES = {
    "divides": (32, 8, 1),
    "pads": (30, 8, 1),
    "clamps": (32, 64, 1),
    "shards_pad": (32, 3, 4),
    "shards_dense": (30, 4, 4),  # 30 does not divide over 4 shards: dense
    "one_token": (1, 8, 1),
}


@pytest.mark.parametrize("case", list(FF_CASES))
def test_feedforward_chunks_match_jax(case):
    """The blockwise FeedForward against the JAX one at the same chunk and
    shards: output and the input's and weights' gradients (``jax.vjp``)."""
    n, chunk, shards = FF_CASES[case]
    dim = 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    g = rng.standard_normal((2, n, dim)).astype(np.float32)
    jff = JaxFeedForward(dim, 4, chunk_size=chunk, seq_shards=shards)
    params = jff.init(jax.random.PRNGKey(1), jnp.asarray(x))
    out, vjp = jax.vjp(lambda p, x: jff.apply(p, x), params, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    ff = FeedForward(dim, 4, device="cpu", chunk_size=chunk, seq_shards=shards)
    p = params["params"]
    with torch.no_grad():
        ff.norm.gamma.copy_(torch.tensor(np.asarray(p["RMSNorm_0"]["gamma"])))
        ff.proj_in.weight.copy_(torch.tensor(np.asarray(p["Dense_0"]["kernel"]).T))
        ff.proj_out.weight.copy_(torch.tensor(np.asarray(p["Dense_1"]["kernel"]).T))
    xt = torch.from_numpy(x).requires_grad_()
    got = ff(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=1e-5)
    dp = dparams["params"]
    np.testing.assert_allclose(ff.proj_in.weight.grad.numpy(),
                               np.asarray(dp["Dense_0"]["kernel"]).T, atol=1e-5)
    np.testing.assert_allclose(ff.norm.gamma.grad.numpy(),
                               np.asarray(dp["RMSNorm_0"]["gamma"]), atol=1e-5)
    expected = None if case in ("clamps", "shards_dense", "one_token") else min(chunk, n // shards)
    assert ff.chunk_for(n) == expected


@pytest.mark.parametrize("chunk", [4, 11])
def test_ff_chunk_size_matches_jax(chunk):
    """The model with ``ff_chunk_size`` (dividing the 32 positions, and
    padding them) gives the JAX loss and gradients."""
    _hold_local(_port(ff_chunk_size=chunk))


# ----------------------------------------------------------------------
# the chunked loss
# ----------------------------------------------------------------------

# name: (form of the inputs, loss_chunk_size)
LOSS_CASES = {"ignore_index": ("ignore", 7), "segment_ids": ("segments", 5),
              "example_mask": ("example_mask", 16), "clamped": ("plain", 1000),
              "one_chunk_per_position": ("plain", 1)}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_chunked_loss_matches_jax(case):
    """``loss_chunk_size`` with ``ignore_index`` labels, packed ids (the
    labels that start a document drop out), an example mask, a chunk longer
    than the sequence (clamped) and chunks of one position: the JAX dense
    loss and gradients."""
    form, chunk = LOSS_CASES[case]
    kw = dict(ignore_index=5) if form == "ignore" else {}
    _hold_local(_port(loss_chunk_size=chunk, **kw), form)


# ----------------------------------------------------------------------
# the windowed decode cache
# ----------------------------------------------------------------------

WINDOWED = dict(max_lookback_seq_len=(4, None))


@functools.cache
def _jax_windowed_decode(quantize: bool, prompt: int):
    """The JAX windowed model's prefill logits and two decode steps'."""
    jm = JaxTransformer(**CONFIG, **WINDOWED, windowed_cache=True, quantize_cache=quantize)
    params, tokens = _jax_params(), jnp.asarray(_tokens(4, n=prompt + 2))
    cache = jm.apply(params, 2, 16, method=jm.init_cache)
    sizes = [c[0].shape[2] if quantize else c.shape[2] for c in cache["k"]]
    logits, cache = jax.jit(lambda p, t, c: jm.apply(p, t, c, method=jm.prefill))(
        params, tokens[:, :prompt], cache)
    step = jax.jit(lambda p, t, c, i: jm.apply(p, t, c, i, method=jm.decode_step))
    out = [np.asarray(logits)]
    for pos in (prompt, prompt + 1):
        logits, cache = step(params, tokens[:, pos], cache, jnp.int32(pos))
        out.append(np.asarray(logits))
    return np.stack(out), sizes


# name: (impl, quantize_cache, prompt length)
WINDOW_CASES = {"cuda_plain": ("cuda", False, 10), "cuda_int8": ("cuda", True, 10),
                "torch_plain": ("torch", False, 10), "cuda_short_prompt": ("cuda", False, 3)}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_cache_matches_jax_decode(case):
    """``windowed_cache`` with a 4-token window in layer 0: the cache sizes
    (4 and 16 slots), and a prompt longer than the window (prefill keeps its
    last 4 rows, rolled into slot order) or shorter, then two decode steps
    (the decode kernel's plain version reads the ring buffer through its
    ``kv_mask``; int8: B6's): the JAX windowed model's logits."""
    impl, quantize, prompt = WINDOW_CASES[case]
    want, sizes = _jax_windowed_decode(quantize, prompt)
    model = _port(**WINDOWED, impl=impl, windowed_cache=True, quantize_cache=quantize)
    tokens = torch.from_numpy(_tokens(4, n=prompt + 2)).long()
    with torch.inference_mode():
        cache = model.init_cache(2, 16)
        assert [c[0].shape[2] if quantize else c.shape[2] for c in cache["k"]] == sizes == [4, 16]
        logits, cache = model.prefill(tokens[:, :prompt], cache)
        got = [logits.numpy()]
        for pos in (prompt, prompt + 1):
            logits, cache = model.decode_step(tokens[:, pos], cache, pos)
            got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got), want,
                               atol=Q8_DECODE_ATOL if quantize else DECODE_ATOL)


def test_unwindowed_cache_refuses_a_long_prompt():
    """A prompt longer than a cache that does not cover a window raises
    JAX's "window-sized" ``ValueError``, on both sides."""
    kw = dict(windowed_cache=True)
    tokens = _tokens(4, n=12)
    jm = JaxTransformer(**CONFIG, **kw)
    cache = jm.apply(_jax_params(), 2, 8, method=jm.init_cache)
    with pytest.raises(ValueError, match="window-sized") as jax_err:
        jm.apply(_jax_params(), jnp.asarray(tokens), cache, method=jm.prefill)
    model = _port(**kw)
    with pytest.raises(ValueError, match="window-sized") as err:
        model.prefill(torch.from_numpy(tokens).long(), model.init_cache(2, 8))
    assert str(err.value) == str(jax_err.value)


# ----------------------------------------------------------------------
# the offloaded optimizer state
# ----------------------------------------------------------------------


def test_offload_opt_state_on_the_cpu_is_the_plain_step():
    """On the CPU ``offload_opt_state`` changes nothing: two Adam steps give
    the plain step's parameters and state bit for bit, and the state stays
    where Adam put it."""
    tokens = torch.from_numpy(_tokens(5)).long()
    runs = []
    for offload in (False, True):
        model = _port()
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        step = make_train_step(lambda t, m=model: m(t, return_loss=True), opt,
                               offload_opt_state=offload)
        losses = [float(step(tokens)) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()],
                     [t.clone() for s in opt.state.values() for t in s.values()]))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) and b.device.type == "cpu" and not b.is_pinned()
               for a, b in zip(s0, s1))
