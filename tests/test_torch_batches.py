"""Parity: process-local batches, port vs JAX package, on the CPU.

- The ragged-batch helpers on the ``Ring`` seam (``gather_sizes``,
  ``all_gather_variable``, ``compact_masked``, ``split_by_rank``,
  ``fold_batch_into_seq``, ``unfold_seq_into_batch``) on a
  ``VirtualRing(8)`` against ``ring_attention_tpu.parallel.collectives``
  under ``shard_map`` on the 8 CPU devices, on the same numpy inputs
  (``tests/test_collectives.py:34-121``; the padded-batch recipe of
  ``tests/test_transformer.py:265-279``), exactly.
- ``shard_batch``: in one process the whole batch on the device (rank-1
  leaves and scalars as they are), as JAX's ``device_put``; on a factored
  mesh each combined rank ``(r, u)`` keeps subchunk ``u`` of ring chunk
  ``r``, the block JAX's ``shard_batch`` gives device ``(u, r)``
  (``tests/test_hybrid.py:315``).
- ``RingTransformer(auto_shard=False)``: in one process the JAX meaning
  (tokens padded and in the ring's layout; the loss of their next-token
  labels), loss and gradients against the JAX model within
  ``tests/test_torch_ring_model.py``'s tolerances; on four gloo processes
  (data 2 x ring 2, and the hybrid ring 2 x ulysses 2), each process fed
  ``shard_batch`` of its rows, the block's logits, the loss and the
  parameters after one SGD step over the mesh equal the ``auto_shard=True``
  model's bit for bit (``tests/torch_variants_dist_worker.py``).  The
  ragged gather crosses the processes there too.
"""

import copy
import functools
import multiprocessing
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import collectives as jcoll
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import shard_batch as jax_shard_batch
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import RingTransformer, export_jax_params, load_jax_params
from ring_attention_tpu_torch.parallel import (
    Mesh,
    Ring,
    VirtualRing,
    all_gather_variable,
    compact_masked,
    create_mesh,
    fold_batch_into_seq,
    gather_sizes,
    shard_batch,
    split_by_rank,
    unfold_seq_into_batch,
)

from torch_variants_dist_worker import BATCH_CASES, JOIN_TIMEOUT_S, WORLD, run_batches

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_ring_model.py


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_seq(fn, *args, in_specs, out_specs):
    mesh = jax_create_mesh(ring_size=8, data_size=1)
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)(*args)


# ---------------------------------------------------------------------------
# the ragged-batch helpers (tests/test_collectives.py:34-121)
# ---------------------------------------------------------------------------


def test_gather_sizes_equals_jax():
    want = _jax_seq(lambda _: jcoll.gather_sizes(jax.lax.axis_index("seq") * 2, "seq"),
                    jnp.zeros(8), in_specs=P("seq"), out_specs=P(None))
    got = gather_sizes([r * 2 for r in range(8)], VirtualRing(8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gather_sizes([torch.tensor(5)], VirtualRing(1)).tolist() == [5]


@functools.cache
def _jax_variable(axis):
    """JAX's ``all_gather_variable`` of rank r's first r + 1 entries (the
    reference's variable-batch pattern) and ``compact_masked`` of it."""
    data = _np((8 * 8, 4) if axis == 0 else (4, 8 * 8), np.random.default_rng(0))
    lengths = jnp.arange(1, 9, dtype=jnp.int32)
    spec = P("seq", None) if axis == 0 else P(None, "seq")

    def core(x, lengths):
        return jcoll.all_gather_variable(x, lengths[jax.lax.axis_index("seq")], "seq",
                                         max_size=8, axis=axis)

    g, m = _jax_seq(core, jnp.asarray(data), lengths, in_specs=(spec, P()),
                    out_specs=(P(None, None), P()))
    return data, np.asarray(g), np.asarray(m), np.asarray(jcoll.compact_masked(g, m, axis=axis))


@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather_variable_equals_jax(axis):
    data, jg, jm, jdense = _jax_variable(axis)
    shards = [torch.from_numpy(s) for s in np.split(data, 8, axis=axis)]
    g, m = all_gather_variable(shards, [r + 1 for r in range(8)], VirtualRing(8),
                               max_size=8, axis=axis)
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(m.numpy(), jm)
    dense = compact_masked(g, m, axis=axis)
    np.testing.assert_array_equal(dense.numpy(), jdense)
    assert dense.shape[axis] == 36


def test_ragged_helpers_check_their_inputs():
    g = torch.zeros(16, 2)
    with pytest.raises(ValueError, match="mask shape"):
        compact_masked(g, torch.ones(15, dtype=torch.bool))
    with pytest.raises(ValueError, match="pad x to max_size 4"):
        all_gather_variable([torch.zeros(3, 2), torch.zeros(4, 2)], [1, 1], VirtualRing(2),
                            max_size=4)
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        split_by_rank(torch.zeros(8), VirtualRing(3))
    with pytest.raises(ValueError, match="does not divide into 4 groups"):
        fold_batch_into_seq(torch.zeros(6, 2), 4)


def test_all_gather_variable_carries_gradients():
    """The gather is ``Ring.all_gather``: each rank's shard gets its slice
    of the gathered gradient back."""
    shards = [torch.full((2, 3), float(r), requires_grad=True) for r in range(4)]
    g, m = all_gather_variable(shards, [1, 2, 0, 2], VirtualRing(4))
    (g * torch.arange(8.0)[:, None]).sum().backward()
    for r, s in enumerate(shards):
        assert s.grad[:, 0].tolist() == [2.0 * r, 2.0 * r + 1]
    assert m.tolist() == [True, False, True, True, False, False, True, True]


def test_split_by_rank_equals_jax():
    x = _np((64, 3), np.random.default_rng(1))
    want = _jax_seq(partial(jcoll.split_by_rank, axis_name="seq"), jnp.asarray(x),
                    in_specs=P(), out_specs=P("seq", None))
    got = split_by_rank(torch.from_numpy(x), VirtualRing(8))
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))
    assert [tuple(s.shape) for s in got] == [(8, 3)] * 8


def test_fold_roundtrip_equals_jax():
    x = _np((6, 10, 3), np.random.default_rng(2))
    y = fold_batch_into_seq(torch.from_numpy(x), 3)
    assert y.shape == (2, 30, 3)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jcoll.fold_batch_into_seq(
        jnp.asarray(x), 3)))
    np.testing.assert_array_equal(unfold_seq_into_batch(y, 3).numpy(), x)


def test_variable_batch_gather_roundtrip():
    """``tests/test_transformer.py:265-279``: ragged per-rank batches (rank r
    holds ``(1 + r) % 4`` real rows of at most 3) gather into (padded
    global, mask) whose real rows are exactly the unpadded examples; the
    mask is what ``example_mask`` takes."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 64, (8 * 3, 8)).astype(np.int32)
    lengths = [(1 + r) % 4 for r in range(8)]
    g, m = all_gather_variable(list(torch.from_numpy(x).split(3)), lengths, VirtualRing(8),
                               axis=0)
    assert g.shape == (24, 8) and int(m.sum()) == sum(lengths)
    want = np.zeros(24, bool)
    for r, n in enumerate(lengths):
        want[r * 3:r * 3 + n] = True
    np.testing.assert_array_equal(m.numpy(), want)
    np.testing.assert_array_equal(compact_masked(g, m).numpy(), x[want])


# ---------------------------------------------------------------------------
# shard_batch (tests/test_collectives.py:122, tests/test_hybrid.py:315)
# ---------------------------------------------------------------------------


def test_shard_batch_places_on_the_mesh():
    """In one process the batch lands whole on the device: ``(b, n)``
    leaves, rank-1 leaves (one value a row) and scalars, as JAX's
    ``device_put`` keeps their values."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (4, 64)).astype(np.int32)
    weights = _np((4,), rng)
    placed = shard_batch({"tokens": tokens, "weights": weights, "step": 3},
                         create_mesh(ring_size=4), device="cpu")
    np.testing.assert_array_equal(placed["tokens"].numpy(), tokens)
    np.testing.assert_array_equal(placed["weights"].numpy(), weights)
    assert int(placed["step"]) == 3 and placed["tokens"].device.type == "cpu"
    jax_placed = jax_shard_batch({"tokens": tokens}, jax_create_mesh(ring_size=4, data_size=2))
    np.testing.assert_array_equal(np.asarray(jax_placed["tokens"]), placed["tokens"].numpy())
    assert shard_batch(tokens, None, device="cpu").shape == (4, 64)


class _Rank(Ring):
    """Rank ``rank`` of a ring of processes, as a process sees it (no
    collective is called)."""

    def __init__(self, world, rank):
        self.world, self.ranks = world, (rank,)

    def rotate(self, payloads, shift):
        raise AssertionError("never reached")

    all_gather = all_reduce = all_to_all = rotate


def test_shard_batch_factored():
    """Combined rank ``(r, u)`` of ring 4 x ulysses 2 keeps subchunk ``u``
    of contiguous ring chunk ``r``: the block JAX's ``shard_batch`` gives
    device ``(u, r)`` of its ``(1, 2, 4)`` mesh."""
    batch = np.arange(2 * 16, dtype=np.int32).reshape(2, 16)
    jmesh = jax_create_mesh(ulysses_size=2, ring_size=4, data_size=1)
    arr = jax_shard_batch(batch, jmesh)
    jax_blocks = {}
    for shard in arr.addressable_shards:
        _, r, u = np.argwhere(np.vectorize(lambda dev: dev == shard.device)(jmesh.devices))[0]
        jax_blocks[int(r), int(u)] = np.asarray(shard.data)
    for (r, u), want in jax_blocks.items():
        mesh = Mesh(data=1, seq=8, ring=_Rank(4, r), ulysses=2, ulysses_ring=_Rank(2, u))
        assert mesh.seq_ranks == (r * 2 + u,)
        got = shard_batch({"tokens": batch, "rows": batch[:, 0]}, mesh, device="cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(), want)
        np.testing.assert_array_equal(got["rows"].numpy(), batch[:, 0])
        # one token past the block: the label of its last position
        with_label = shard_batch(np.arange(17)[None], mesh, overlap=1, device="cpu")
        assert with_label.tolist() == [list(range((r * 2 + u) * 2, (r * 2 + u) * 2 + 3))]
    with pytest.raises(ValueError, match="does not divide over the sequence world 8"):
        shard_batch(np.zeros((1, 12)), mesh, device="cpu")


# ---------------------------------------------------------------------------
# RingTransformer(auto_shard=False)
# ---------------------------------------------------------------------------

CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, bucket_size=16)


def _tokens(seed, b=2, n=129):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_local_batches():
    jm = JaxTransformer(**CONFIG, auto_shard=False,
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)[:, :128]))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jnp.asarray(_tokens(1)), return_loss=True)))(params)
    return jax.tree_util.tree_map(np.asarray, params), float(loss), grads


def test_auto_shard_false_in_one_process_equals_jax():
    """In one process ``auto_shard=False`` takes the tokens padded and in
    the ring's layout, and its loss the next token of that layout, as the
    JAX model's does: loss and every gradient."""
    params, ref_loss, ref_grads = _jax_local_batches()
    tm = load_jax_params(RingTransformer(**CONFIG, auto_shard=False, device="cpu",
                                         mesh=create_mesh(ring_size=4)), params)
    loss = tm(torch.from_numpy(_tokens(1)), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    holder = copy.deepcopy(tm)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), tm.parameters()):
            p.copy_(src.grad)
    got = dict(jax.tree_util.tree_leaves_with_path(export_jax_params(holder)))
    for path, r in jax.tree_util.tree_leaves_with_path(ref_grads):
        np.testing.assert_allclose(got[path], np.asarray(r), err_msg=str(path), **GRAD_TOL)


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_batches")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_batches, args=(r, str(tmp / "store"), str(tmp)))
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
            for name in [*BATCH_CASES, "ragged"] for r in range(WORLD)}


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_auto_shard_false_on_processes(dist_results, name):
    """Each process fed ``shard_batch`` of its rows (one token of overlap):
    its block's logits, the loss and the parameters after one SGD step
    over the mesh equal the ``auto_shard=True`` model's bit for bit, and
    the parameters agree across the processes."""
    for r in range(WORLD):
        got = dist_results[name, r]
        np.testing.assert_array_equal(got["local_logits"], got["auto_logits"])
        assert got["local_loss"] == got["auto_loss"]
        params = sorted(k for k in got if k.startswith("auto_param"))
        for key in params:
            np.testing.assert_array_equal(got[key.replace("auto", "local")], got[key],
                                          err_msg=f"{key} rank {r}")
            np.testing.assert_array_equal(got[key], dist_results[name, 0][key])
    # the parts: a row group's blocks, one token of overlap each
    n_local = 128 // (4 if name == "hybrid" else 2)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 129))
    for r in range(WORLD):
        rows = slice(0, 2) if name == "hybrid" else slice(r // 2, r // 2 + 1)
        seq = r if name == "hybrid" else r % 2
        want = tokens[rows, seq * n_local:(seq + 1) * n_local + 1]
        np.testing.assert_array_equal(dist_results[name, r]["part"], want)


def test_ragged_gather_on_processes(dist_results):
    """``gather_sizes`` and ``all_gather_variable`` over the four processes:
    the same gathered rows and mask on every process as on a
    ``VirtualRing(4)``."""
    from torch_variants_dist_worker import ragged_case

    ref = ragged_case(VirtualRing(4))
    for r in range(WORLD):
        for key in ("sizes", "gathered", "mask", "dense"):
            np.testing.assert_array_equal(dist_results["ragged", r][key], ref[key])
