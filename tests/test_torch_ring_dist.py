"""The ring over ``torch.distributed``: four gloo processes on the CPU.

Each process holds one rank of a ``DistributedRing`` (``create_mesh`` over
the initialized process group: one ring of 4, and a data 2 x ring 2 mesh)
and runs ``ring_flash_attention`` forward and backward on its shard of the
same seeded inputs (``impl="fused"`` gathers k, v and the key mask with
``DistributedRing.all_gather``, and the kv document ids in its packed
case; the scan ring's packed case rotates the ids with k and v and skips
the hops they share no document with; the int8 cases rotate, or gather,
the int8 payload or feed quantized once at ring entry).  Every shard of the output and of dq, dk and dv must
equal, bit for bit, the ``VirtualRing`` run of the same ranks in this
process: the same arithmetic in the same order, only the transport differs.
The same processes run the collectives of tree decoding and zig-zag:
``Ring.all_reduce`` ("max" and "sum") and the gather's backward (the
reduce-scatter, an all-reduce whose own slice each rank keeps), each held
to its exact value; ``tree_attn_decode`` on each rank's cache shard
(``impl="torch"``, ``"cuda"`` and an int8 cache); and ``zigzag_attention``
forward and backward on each rank's zig-zag shard (``"torch"``, ``"cuda"``,
packed ids).  Each is held to its ``VirtualRing`` run: bit for bit where no
sum crosses ranks (zig-zag's output and dq, the maxima), and within 1e-6
norm-relative where one does (the tree merge's sums, zig-zag's dk and dv,
the gathered gradient): gloo sums the ranks in another order.
The processes rendezvous through a ``FileStore`` under the test's temporary
directory (no TCP port, so test files can run side by side), are joined
with a timeout, and any straggler is terminated and fails the test.
"""

import multiprocessing
import traceback

import numpy as np
import pytest
import torch

from ring_attention_tpu_torch import quantize_kv_cache
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    ring_flash_attention,
    tree_attn_decode,
    zigzag_attention,
    zigzag_permute,
)

WORLD = 4
JOIN_TIMEOUT_S = 120
# name: (ring size, data size, ring kwargs)
CASES = {
    # a window of 20 over shards of 16 needs 3 of the 4 passes: the dk/dv
    # catch-up rotation runs
    "window_passes_torch": (4, 1, dict(causal=True, window=20, max_ring_passes=3,
                                       impl="torch", bucket_size=8)),
    "window_passes_cuda": (4, 1, dict(causal=True, window=20, max_ring_passes=3,
                                      impl="cuda")),
    "striped_gqa_cuda": (4, 1, dict(causal=True, striped=True, impl="cuda")),
    "data2_ring2_mask_torch": (2, 2, dict(impl="torch", bucket_size=8, masked=True)),
    "data2_ring2_mask_cuda": (2, 2, dict(impl="cuda", masked=True)),
    # the fused ring: one all-gather of k, v (and the mask) per call
    "window_passes_fused": (4, 1, dict(causal=True, window=20, max_ring_passes=3,
                                       impl="fused")),
    "striped_gqa_fused": (4, 1, dict(causal=True, striped=True, impl="fused")),
    "data2_ring2_mask_fused": (2, 2, dict(impl="fused", masked=True)),
    # packed documents: ranks 2 and 3 skip the hop whose keys are rank 0's
    "packed_cuda": (4, 1, dict(causal=True, impl="cuda", packed=True)),
    # the fused ring with ids: the kv ids gathered with k and v (B7's ids)
    "packed_fused": (4, 1, dict(causal=True, impl="fused", packed=True)),
    # the int8 wire: K/V quantized once at ring entry, rotated as one int8
    # tensor (the ids and the mask beside it); under int8 compute the tensor
    # is the int8 sweep's feed, also without the wire
    "int8_wire_torch": (4, 1, dict(causal=True, impl="torch", bucket_size=8,
                                   hop_compression="int8")),
    "int8_wire_q8_striped_cuda": (4, 1, dict(causal=True, striped=True, impl="cuda",
                                             bucket_size=8, hop_compression="int8",
                                             compute_dtype="int8")),
    "int8_q8_packed_cuda": (4, 1, dict(causal=True, impl="cuda", bucket_size=8,
                                       compute_dtype="int8", packed=True)),
    # the fused ring's int8 feed over the gathered payloads (B7), with ids and
    # with a key mask (a DistributedRing, like a masked ring, takes B7)
    "int8_wire_q8_packed_fused": (4, 1, dict(causal=True, impl="fused", bucket_size=8,
                                             hop_compression="int8", compute_dtype="int8",
                                             packed=True)),
    "int8_wire_q8_mask_fused": (2, 2, dict(impl="fused", bucket_size=8,
                                           hop_compression="int8", compute_dtype="int8",
                                           masked=True)),
    # compression alone on the fused ring: the codec round trip, float B7
    "int8_wire_fused": (4, 1, dict(causal=True, window=20, max_ring_passes=3,
                                   impl="fused", hop_compression="int8")),
}


def _inputs(seed=0, b=2, h=4, hk=2, n=64, d=16):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    mask = rng.random((b, n)) > 0.3
    seg = np.repeat(np.int32([0, 1, 2]), [20, 11, n - 31])[None].repeat(b, 0)
    return q, k, v, mask, seg, do


def _run(q, k, v, mask, seg, do, ring, kw):
    """Output and gradients of one ring call on these (local) shards."""
    kw = dict(kw)
    masked = kw.pop("masked", False)
    packed = kw.pop("packed", False)
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ring_flash_attention(*x, torch.from_numpy(mask) if masked else None,
                               ring, segment_ids=torch.from_numpy(seg) if packed else None,
                               **kw)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [a.grad.numpy() for a in x]


def _shard(arrays, data_rank, data, seq_rank, ring_size):
    """This process's block of the global arrays: its batch rows and its
    sequence shard (axis 2 of q/k/v/do, axis 1 of the mask and the ids)."""
    out = []
    for a in arrays:
        b, axis = a.shape[0] // data, 2 if a.ndim == 4 else 1
        n = a.shape[axis] // ring_size
        rows = a[data_rank * b:(data_rank + 1) * b]
        out.append(np.ascontiguousarray(
            np.take(rows, range(seq_rank * n, (seq_rank + 1) * n), axis=axis)))
    return out


# Tree decoding and zig-zag on the ring of 4: name -> kwargs
DECODE_CASES = {
    "tree_decode_torch": dict(impl="torch", bucket_size=8),
    "tree_decode_cuda": dict(impl="cuda"),
    "tree_decode_q8": dict(quantized=True),
}
ZIGZAG_CASES = {
    "zigzag_torch": dict(impl="torch", bucket_size=16),
    "zigzag_cuda": dict(impl="cuda"),
    "zigzag_packed_cuda": dict(impl="cuda", packed=True),
}
CROSS_RANK_REL_TOL = 1e-6


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _decode_inputs(seed=1, b=2, h=4, hk=2, n=64, d=16):
    """q, the cache and its validity mask (the first 21 slots: ranks 2 and 3
    hold no valid key)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    mask = np.broadcast_to(np.arange(n)[None, :] < 21, (b, n)).copy()
    return q, k, v, mask


def _decode(q, k, v, mask, ring, kw):
    """The merged output (the same on every rank) for the cache shards of
    the ranks this ring holds, concatenated in ``k``, ``v`` and ``mask``."""
    kw = dict(kw)
    count = len(ring.ranks)
    k, v = ([s.contiguous() for s in torch.from_numpy(a).chunk(count, 2)] for a in (k, v))
    masks = [s.contiguous() for s in torch.from_numpy(mask).chunk(count, 1)]
    if kw.pop("quantized", False):
        out = tree_attn_decode(torch.from_numpy(q), None, None, masks, ring=ring,
                               kv_quantized=[quantize_kv_cache(a, b) for a, b in zip(k, v)],
                               **kw)
    else:
        out = tree_attn_decode(torch.from_numpy(q), k, v, masks, ring=ring, **kw)
    return [out.numpy()]


def _zigzag_global(seed=2, b=2, h=4, hk=2, n=64, d=16):
    """Zig-zag-permuted q, k, v, do and packed ids (three documents)."""
    q, k, v, _, seg, do = _inputs(seed, b, h, hk, n, d)
    perm = [zigzag_permute(torch.from_numpy(a), WORLD, axis=2).numpy() for a in (q, k, v, do)]
    seg = zigzag_permute(torch.from_numpy(seg), WORLD, axis=1).numpy()
    return perm[:3] + [seg, perm[3]]


def _zigzag(q, k, v, seg, do, ring, kw):
    kw = dict(kw)
    packed = kw.pop("packed", False)
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = zigzag_attention(*x, ring, segment_ids=torch.from_numpy(seg) if packed else None,
                           **kw)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [a.grad.numpy() for a in x]


def _collective_inputs(rank, n=12):
    """Rank ``rank``'s payload and the weights its loss puts on the
    gathered tensor."""
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal((2, n)).astype(np.float32),
            rng.standard_normal((2, WORLD * n)).astype(np.float32))


def _collectives(ring):
    """Max, sum and the gathered gradient of every rank this ring holds."""
    xs = [torch.from_numpy(_collective_inputs(r)[0]) for r in ring.ranks]
    maxima = [p[0].numpy() for p in ring.all_reduce([(x,) for x in xs], "max")]
    sums = [p[0].numpy() for p in ring.all_reduce([(x,) for x in xs], "sum")]
    leaves = [x.clone().requires_grad_() for x in xs]
    gathered = ring.all_gather([(x,) for x in leaves], dim=1)
    loss = sum((g[0] * torch.from_numpy(_collective_inputs(r)[1])).sum()
               for r, g in zip(ring.ranks, gathered))
    loss.backward()
    return maxima, sums, [x.grad.numpy() for x in leaves]


def _worker(rank, store_path, out_dir):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                                rank=rank, world_size=WORLD)
        meshes = {(4, 1): create_mesh(), (2, 2): create_mesh(ring_size=2, data_size=2)}
        for name, (ring_size, data, kw) in CASES.items():
            mesh = meshes[ring_size, data]
            assert mesh.shape == {"data": data, "seq": ring_size}
            shards = _shard(_inputs(), mesh.data_rank, data, mesh.ring.rank, ring_size)
            np.savez(f"{out_dir}/{name}_{rank}.npz", *_run(*shards, mesh.ring, kw))
        ring = meshes[4, 1].ring
        q, k, v, mask = _decode_inputs()
        k, v, mask = _shard([k, v, mask], 0, 1, ring.rank, WORLD)
        for name, kw in DECODE_CASES.items():
            np.savez(f"{out_dir}/{name}_{rank}.npz", *_decode(q, k, v, mask, ring, kw))
        shards = _shard(_zigzag_global(), 0, 1, ring.rank, WORLD)
        for name, kw in ZIGZAG_CASES.items():
            np.savez(f"{out_dir}/{name}_{rank}.npz", *_zigzag(*shards, ring, kw))
        maxima, sums, grads = _collectives(ring)
        np.savez(f"{out_dir}/collectives_{rank}.npz", maxima[0], sums[0], grads[0])
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


@pytest.fixture(scope="module")
def distributed_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_ring")
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
    return tmp


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_ring_equals_virtual_ring(distributed_results, name):
    ring_size, data, kw = CASES[name]
    q, k, v, mask, seg, do = _inputs()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for data_rank in range(data):
            rows = slice(data_rank * q.shape[0] // data, (data_rank + 1) * q.shape[0] // data)
            virtual = _run(q[rows], k[rows], v[rows], mask[rows], seg[rows], do[rows],
                           VirtualRing(ring_size), kw)
            for seq_rank in range(ring_size):
                rank = data_rank * ring_size + seq_rank
                got = np.load(distributed_results / f"{name}_{rank}.npz")
                want = _shard(virtual, 0, 1, seq_rank, ring_size)
                for label, g, w in zip(("out", "dq", "dk", "dv"), got.values(), want):
                    assert np.array_equal(g, w), (label, rank)
    finally:
        torch.set_num_threads(threads)


def _virtual(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_distributed_tree_decode_equals_virtual_ring(distributed_results, name):
    """The merged output on every rank: within 1e-6 of the VirtualRing's
    (the merge's sums cross ranks)."""
    (want,) = _virtual(lambda: _decode(*_decode_inputs(), VirtualRing(WORLD),
                                       DECODE_CASES[name]))
    for rank in range(WORLD):
        (got,) = np.load(distributed_results / f"{name}_{rank}.npz").values()
        assert _rel(got, want) <= CROSS_RANK_REL_TOL, (rank, _rel(got, want))


@pytest.mark.parametrize("name", list(ZIGZAG_CASES))
def test_distributed_zigzag_equals_virtual_ring(distributed_results, name):
    """Each rank's output and dq bit for bit; dk and dv (summed over the
    ranks that attend each key) within 1e-6."""
    virtual = _virtual(lambda: _zigzag(*_zigzag_global(), VirtualRing(WORLD),
                                       ZIGZAG_CASES[name]))
    for rank in range(WORLD):
        got = list(np.load(distributed_results / f"{name}_{rank}.npz").values())
        want = _shard(virtual, 0, 1, rank, WORLD)
        for label, g, w in zip(("out", "dq"), got, want):
            assert np.array_equal(g, w), (label, rank)
        for label, g, w in zip(("dk", "dv"), got[2:], want[2:]):
            assert _rel(g, w) <= CROSS_RANK_REL_TOL, (label, rank, _rel(g, w))


def _expected_collectives():
    xs = [_collective_inputs(r)[0] for r in range(WORLD)]
    ws = [_collective_inputs(r)[1] for r in range(WORLD)]
    n = xs[0].shape[1]
    grads = [sum(w[:, r * n:(r + 1) * n] for w in ws) for r in range(WORLD)]
    return np.max(xs, axis=0), np.sum(xs, axis=0, dtype=np.float64), grads


@pytest.mark.parametrize("ring_kind", ["virtual", "distributed"])
def test_ring_all_reduce_and_gather_backward(distributed_results, ring_kind):
    """``Ring.all_reduce`` gives every rank the elementwise max (exactly)
    and sum; the gather's backward gives each rank the sum, over the ranks,
    of the gradient of its slice of the gathered tensor."""
    maxima, sums, grads = _expected_collectives()
    if ring_kind == "virtual":
        got = _collectives(VirtualRing(WORLD))
    else:
        loaded = [list(np.load(distributed_results / f"collectives_{r}.npz").values())
                  for r in range(WORLD)]
        got = [[x[i] for x in loaded] for i in range(3)]
    for rank in range(WORLD):
        assert np.array_equal(got[0][rank], maxima), rank
        np.testing.assert_allclose(got[1][rank], sums, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[2][rank], grads[rank], rtol=1e-6, atol=1e-6)
