"""The ring over ``torch.distributed``: four gloo processes on the CPU.

Each process holds one rank of a ``DistributedRing`` (``create_mesh`` over
the initialized process group: one ring of 4, and a data 2 x ring 2 mesh)
and runs ``ring_flash_attention`` forward and backward on its shard of the
same seeded inputs (``impl="fused"`` gathers k, v and the key mask with
``DistributedRing.all_gather``; a packed case rotates the kv document ids
with k and v and skips the hops they share no document with).  Every shard of the output and of dq, dk and dv must
equal, bit for bit, the ``VirtualRing`` run of the same ranks in this
process: the same arithmetic in the same order, only the transport differs.
The processes rendezvous through a ``FileStore`` under the test's temporary
directory (no TCP port, so test files can run side by side), are joined
with a timeout, and any straggler is terminated and fails the test.
"""

import multiprocessing
import traceback

import numpy as np
import pytest
import torch

from ring_attention_tpu_torch.parallel import VirtualRing, create_mesh, ring_flash_attention

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
