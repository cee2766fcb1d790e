"""The model over ``torch.distributed``: four gloo processes on the CPU.

Each process builds ``RingTransformer`` on ``create_mesh`` over the
initialized process group (a ``DistributedRing`` of 4, and a data 2 x ring
2 mesh with its data ring), loads the same weights (one seeded JAX init,
``load_jax_params``) and passes the same global tokens, ids and masks; the
model keeps its rows and seq block, runs the layers on them and returns the
global logits, and with ``return_loss`` the global loss, whose gradient is
the process's share: the sum over the mesh (``mesh_all_reduce``, what
``make_train_step(mesh=)`` sums) is the whole gradient.  Cases: the ring of
4 with ``impl="torch"``, ``"cuda"`` and ``"fused"`` in both layouts, data 2
x ring 2, ``segment_ids``, ``mask=Causal() & DocumentMask(...)``, zig-zag,
the int8 wire with int8 compute, the memory knobs (``remat`` under
``nothing_saveable`` and ``save_attn`` with ``ff_chunk_size`` and
``loss_chunk_size``), Ulysses over the ring of 4 and the hybrid strategy on
``create_mesh(ring_size=2, ulysses_size=2)`` (its all-to-alls and the
gradient's sum over the ulysses groups cross the processes); three
``make_train_step`` SGD steps with ``clip_grad_norm`` and
``skip_nonfinite`` (ring 4, striped, and data 2 x ring 2); two Adam steps
on data 2 x ring 2 with ``shard_opt_state=True`` (ZeRO-1 over the data
ring), also with ``offload_opt_state=True``, against the same steps without
it; ``prefill`` / ``decode_step`` / ``generate`` (greedy and with a seeded
generator) with a plain and an int8 cache.

Each case is held three ways: against the same model on a ``VirtualRing``
in this process (the forward's logits bit for bit; the loss, the
gradients and what decoding merges within 1e-6 norm-relative: gloo sums
the processes' shares in another order than one process does), against the JAX
model on its 2 x 4 mesh (``GRAD_TOL``; the int8 case against the JAX float
model within the int8 bound, as ``tests/test_torch_int8_ring_model.py``
holds the int8 model on a ``VirtualRing`` to the JAX int8 model), and
across the processes (parameters after the steps equal bit for bit).  A
step that leaves out the mesh's sum (``mesh=None``) drifts from the
``VirtualRing`` step and between the processes.  The processes rendezvous
through a ``FileStore`` under the test's temporary directory, run with
``torch.set_num_threads(1)`` (as the parent's ``VirtualRing`` runs), and
are joined with a timeout.
"""

import functools
import multiprocessing
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ring_attention_tpu.masks import Causal as JaxCausal
from ring_attention_tpu.masks import DocumentMask as JaxDocumentMask
from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.utils.train import init_step_stats as jax_init_step_stats
from ring_attention_tpu.utils.train import make_train_step as jax_make_train_step
from ring_attention_tpu_torch import RingTransformer, export_jax_params, load_jax_params
from ring_attention_tpu_torch.parallel import create_mesh

from torch_model_dist_worker import (
    CASES,
    CLIP,
    CONFIG,
    JOIN_TIMEOUT_S,
    LAYER_CASES,
    LR,
    MAX_LEN,
    PROMPT,
    SERVE_CASES,
    STARTS,
    STEP_CASES,
    STEP_SEEDS,
    STEPS,
    WORLD,
    ZERO_CASES,
    _ids,
    _layer_case,
    _model_case,
    _serve,
    _steps,
    _tokens,
    _worker,
    mesh_kw,
)

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
REL_TOL = 1e-6  # processes vs VirtualRing: the same sums in another order
Q8_FWD_REL_L2 = 2e-2  # tests/test_quant.py: an int8 forward against the float one
LOGITS_ATOL = 1e-4  # tests/test_torch_tree_decode.py


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_model(**kw):
    return JaxTransformer(**{**CONFIG, **kw}, mesh=jax_create_mesh(ring_size=4, data_size=2))


@functools.cache
def _jax_params():
    # the initializers do not read the mesh: init without it skips the
    # ring's compile
    params = JaxTransformer(**CONFIG).init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    return jax.tree_util.tree_map(np.asarray, params)


def _weights():
    """The JAX weights as the port model's state dict."""
    return load_jax_params(RingTransformer(**CONFIG, device="cpu"), _jax_params()).state_dict()


@functools.cache
def _jax_reference(form):
    """Logits, loss and gradients of the JAX model: ``"plain"`` (every
    causal case: the layout and the ring do not change the function),
    ``"segments"`` or ``"doc_mask"``."""
    kw = dict(causal=False, mask=JaxCausal() & JaxDocumentMask(STARTS)) if form == "doc_mask" else {}
    jm, params = _jax_model(**kw), _jax_params()
    ids = jnp.asarray(_ids()) if form == "segments" else None

    @jax.jit  # one compile for the forward and the gradient
    def run(p, tokens, loss_tokens):
        logits = jm.apply(p, tokens, segment_ids=None if ids is None else ids[:, :127])
        return logits, jax.value_and_grad(
            lambda p: jm.apply(p, loss_tokens, return_loss=True, segment_ids=ids))(p)

    logits, (loss, grads) = run(params, jnp.asarray(_tokens(2)[:, :127]),
                                jnp.asarray(_tokens(1)))
    return np.asarray(logits), float(loss), grads


@functools.cache
def _jax_steps():
    """The losses and parameters of the JAX step (SGD, clipping, the
    non-finite guard) on its mesh."""
    jm, params = _jax_model(striped=True), _jax_params()
    step = jax.jit(jax_make_train_step(lambda p, t: jm.apply(p, t, return_loss=True),
                                       optax.sgd(LR), clip_grad_norm=CLIP,
                                       skip_nonfinite=True))
    state, stats, losses = optax.sgd(LR).init(params), jax_init_step_stats(), []
    for seed in STEP_SEEDS:
        params, state, stats, loss = step(params, state, stats, jnp.asarray(_tokens(seed)))
        losses.append(float(loss))
    return np.asarray(losses), params


@functools.cache
def _jax_serving(quantize):
    """The JAX model's prefill and teacher-forced decode logits, and its
    greedy tokens (the same prefill and decode steps, each fed the argmax:
    ``generate``'s greedy loop without a compile of its own)."""
    jm, params = _jax_model(quantize_cache=quantize), _jax_params()
    tokens = _tokens(6, n=PROMPT + STEPS)
    prefill = jax.jit(partial(jm.apply, method=jm.prefill))
    decode = jax.jit(partial(jm.apply, method=jm.decode_step))

    def run(feed):
        cache = jm.apply(params, 2, MAX_LEN, method=jm.init_cache)
        logits, cache = prefill(params, jnp.asarray(tokens[:, :PROMPT]), cache)
        steps = [np.asarray(logits)]
        for pos in range(PROMPT, PROMPT + STEPS - 1):
            logits, cache = decode(params, feed(pos, steps[-1]), cache, jnp.int32(pos))
            steps.append(np.asarray(logits))
        return np.stack(steps)

    forced = run(lambda pos, _: jnp.asarray(tokens[:, pos]))
    greedy = run(lambda pos, last: jnp.asarray(last.argmax(-1)))
    return forced, greedy.argmax(-1).T


def _virtual(fn, ring_size, *args):
    """``fn`` on the same model over a ``VirtualRing`` of ``ring_size`` in
    this process, one thread (as the processes run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(create_mesh(**mesh_kw(ring_size)), *args)
    finally:
        torch.set_num_threads(threads)


@functools.cache
def _virtual_case(name):
    return _virtual(_model_case, CASES[name][0], _weights(), name)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_model")
    torch.save(_weights(), tmp / "weights.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]

    def load(name):
        return [list(np.load(tmp / f"{name}_{rank}.npz").values()) for rank in range(WORLD)]

    return load


def _grad_tree(grads):
    """Gradients in the port's parameter order as a JAX-shaped tree."""
    holder = RingTransformer(**CONFIG, device="cpu")
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(torch.from_numpy(g))
    return export_jax_params(holder)


def _assert_trees_close(got, ref, **tol):
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(r), err_msg=str(path), **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_model_on_processes_equals_virtual_ring(results, name):
    """Every process returns the global logits of the model on a
    ``VirtualRing`` bit for bit (no sum crosses the processes: the ring's
    hops are the same arithmetic, only the transport differs) and its loss,
    and the mesh's sum of the processes' gradients is its gradient."""
    want = _virtual_case(name)
    for rank, got in enumerate(results(name)):
        assert np.array_equal(got[0], want[0]), rank
        for i, (g, w) in enumerate(zip(got[1:], want[1:])):
            assert _rel(g, w) <= REL_TOL, (rank, i, _rel(g, w))


@pytest.mark.parametrize("name", list(CASES))
def test_model_on_processes_matches_jax(results, name):
    got = results(name)[0]
    if name == "int8":
        # the int8 forward against the JAX float model
        logits, _, _ = _jax_reference("plain")
        assert _rel(got[0], logits) <= Q8_FWD_REL_L2, _rel(got[0], logits)
        return
    form = "segments" if CASES[name][3] else {"doc_mask": "doc_mask"}.get(name, "plain")
    logits, loss, grads = _jax_reference(form)
    np.testing.assert_allclose(got[0], logits, **GRAD_TOL)
    np.testing.assert_allclose(float(got[1]), loss, rtol=1e-5)
    _assert_trees_close(_grad_tree(got[2:]), grads, **GRAD_TOL)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_steps_on_processes(results, name):
    """Three guarded, clipped SGD steps: the processes' parameters equal
    bit for bit, the ``VirtualRing`` step's within 1e-6 and the JAX step's
    within GRAD_TOL; the losses likewise."""
    got = results(name)
    for rank in range(1, WORLD):
        for i, (g, w) in enumerate(zip(got[rank], got[0])):
            assert np.array_equal(g, w), (rank, i)
    want = _virtual(_steps, STEP_CASES[name][0], _weights())
    for i, (g, w) in enumerate(zip(got[0], want)):
        assert _rel(g, w) <= REL_TOL, (i, _rel(g, w))
    jax_losses, jax_params = _jax_steps()
    np.testing.assert_allclose(got[0][0], jax_losses, rtol=1e-5)
    holder = load_jax_params(RingTransformer(**CONFIG, device="cpu"), _jax_params())
    with torch.no_grad():
        for p, g in zip(holder.parameters(), got[0][1:]):
            p.copy_(torch.from_numpy(g))
    _assert_trees_close(export_jax_params(holder), jax_params, **GRAD_TOL)


def test_train_step_without_the_seq_sum_drifts(results):
    """The replicated parameters get gradient from each process's own
    tokens only: a step that does not sum over the seq ring moves each
    process elsewhere, none of them where the ``VirtualRing`` step goes."""
    got = results("unsummed")
    want = _virtual(_steps, 4, _weights(), True, STEP_SEEDS[:1])
    for rank in range(WORLD):
        worst = max(_rel(g, w) for g, w in zip(got[rank][1:], want[1:]))
        assert worst > 1e-3, (rank, worst)
    assert not all(np.array_equal(g, w) for g, w in zip(got[0][1:], got[1][1:]))


@pytest.mark.parametrize("name", [n for n in ZERO_CASES if n != "zero1_plain"])
def test_zero1_steps_on_processes(results, name):
    """ZeRO-1 (``shard_opt_state=True``) over the data ring of 2: each
    process holds half of Adam's moments (every parameter's flat half,
    padded), the parameters after two clipped Adam steps equal the steps
    without it bit for bit (Adam is elementwise: the same arithmetic on the
    same numbers, its slice on each process, then gathered) and are the
    same on every process; with ``offload_opt_state`` as well (the CPU
    state stays where it is)."""
    plain, got = results("zero1_plain"), results(name)
    sizes = [p.size for p in got[0][1:]]
    assert int(plain[0][0]) == 2 * sum(sizes)
    for rank in range(WORLD):
        assert int(got[rank][0]) == 2 * sum(-(-n // 2) for n in sizes), rank
        for i, (g, w) in enumerate(zip(got[rank][1:], plain[rank][1:])):
            assert np.array_equal(g, w), (rank, i)
        for i, (g, w) in enumerate(zip(got[rank][1:], got[0][1:])):
            assert np.array_equal(g, w), (rank, i)


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_serving_on_processes(results, name):
    """Prefill and decode logits within 1e-6 of the ``VirtualRing`` model's
    and within LOGITS_ATOL of the JAX model's; greedy tokens equal to both;
    tokens sampled from a seeded generator equal to the ``VirtualRing``
    model's where each process sees every row (data 1)."""
    ring, data, quantize = SERVE_CASES[name]
    want = _virtual(_serve, ring, _weights(), quantize)
    ref_logits, ref_greedy = _jax_serving(quantize)
    for rank, got in enumerate(results(name)):
        assert _rel(got[0], want[0]) <= REL_TOL, (rank, _rel(got[0], want[0]))
        np.testing.assert_allclose(got[0], ref_logits, atol=LOGITS_ATOL)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[1], ref_greedy)
        if data == 1:
            np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_auto_shard_on_processes(results, name):
    """``RingAttention(auto_shard=True)`` takes the global input on every
    process and returns the global output: the ``VirtualRing`` layer's bit
    for bit; the gradient of a loss that every process computes alike on
    that output reaches each process as its own slice, so the mesh's sum is
    the ``VirtualRing`` layer's gradient; ``prefill`` gathers its output
    and writes the cache shard of this process's rank and rows."""
    ring, data = LAYER_CASES[name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _layer_case(create_mesh(ring_size=ring))
    finally:
        torch.set_num_threads(threads)
    n_params = 3
    caches = want[n_params + 2:]
    for rank, got in enumerate(results(name)):
        assert np.array_equal(got[0], want[0]), rank
        for g, w in zip(got[1:n_params + 2], want[1:n_params + 2]):
            assert _rel(g, w) <= REL_TOL, (rank, _rel(g, w))
        data_rank, seq_rank = divmod(rank, ring)
        rows = slice(data_rank * 2 // data, (data_rank + 1) * 2 // data)
        for which, shard in enumerate(got[n_params + 2:]):
            want_shard = caches[which * ring + seq_rank][rows]
            np.testing.assert_allclose(shard, want_shard, rtol=1e-6, atol=1e-6)
