"""Cases and workers of ``tests/test_torch_ring_variants.py`` and
``tests/test_torch_batches.py`` on four gloo processes.  This module
imports no JAX, so that each spawned process starts on torch and the port
alone."""

import copy
import traceback

import numpy as np
import torch

from ring_attention_tpu_torch import RingTransformer, init_random_params, make_train_step
from ring_attention_tpu_torch.parallel import (
    all_gather_variable,
    compact_masked,
    create_mesh,
    gather_sizes,
    ring_flash_attention,
    shard_batch,
)

WORLD = 4
JOIN_TIMEOUT_S = 120
# the ring variants on a ring of 4: name -> ring_flash_attention kwargs
VARIANT_CASES = {
    "counter": dict(impl="cuda", causal=True, striped=True, counter_rotate=True),
    "bidirectional": dict(impl="cuda", causal=True, bidirectional=True),
    "counter_int8": dict(impl="cuda", causal=True, counter_rotate=True,
                         hop_compression="int8", compute_dtype="int8", bucket_size=8),
}
# process-local batches: name -> (create_mesh kwargs, model kwargs)
BATCH_CASES = {
    "data2_ring2": (dict(ring_size=2, data_size=2), dict(impl="cuda")),
    "hybrid": (dict(ring_size=2, ulysses_size=2), dict(impl="cuda", sequence_parallel="hybrid")),
}
CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, bucket_size=16)
LR = 0.5


def _qkv(n=64):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 4, n, 16), (2, 2, n, 16), (2, 2, n, 16), (2, 4, n, 16))]


def variant_case(ring, name) -> dict:
    """Output and gradients of the held ranks' blocks (in the ring's
    layout) of one variant on ``ring``."""
    q, k, v, do = _qkv()
    n_local = q.shape[2] // ring.world
    held = slice(ring.ranks[0] * n_local, (ring.ranks[-1] + 1) * n_local)
    tq, tk, tv = (torch.from_numpy(x[:, :, held].copy()).requires_grad_() for x in (q, k, v))
    out = ring_flash_attention(tq, tk, tv, None, ring, **VARIANT_CASES[name])
    out.backward(torch.from_numpy(do[:, :, held].copy()))
    return dict(out=out.detach().numpy(), dq=tq.grad.numpy(), dk=tk.grad.numpy(),
                dv=tv.grad.numpy())


def _tokens(b=2, n=129):
    return np.random.default_rng(1).integers(0, 256, (b, n))


def batch_case(mesh, name) -> dict:
    """The model with ``auto_shard=True`` on the global batch and with
    ``auto_shard=False`` on this process's part of it (``shard_batch`` of
    the process's rows, one token of overlap for the labels): the
    process's block of logits, the loss, and every parameter after one SGD
    step summed over the mesh, from each."""
    _, kw = BATCH_CASES[name]
    tokens = _tokens()
    rows = slice(mesh.data_rank * 2 // mesh.data, (mesh.data_rank + 1) * 2 // mesh.data)
    part = shard_batch(tokens[rows], mesh, overlap=1, device="cpu")
    result = {}
    state = None
    for auto in (True, False):
        model = RingTransformer(**CONFIG, **kw, device="cpu", mesh=mesh, auto_shard=auto)
        if state is None:
            state = copy.deepcopy(init_random_params(
                model, torch.Generator().manual_seed(0)).state_dict())
        model.load_state_dict(state)
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens[:, :-1]) if auto else part[:, :-1])
        if auto:  # this process's block of the global logits
            logits = shard_batch(logits[rows], mesh, device="cpu")
        step = make_train_step(lambda t, m=model: m(t, return_loss=True),
                               torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
        loss = step(torch.from_numpy(tokens) if auto else part)
        tag = "auto" if auto else "local"
        result[f"{tag}_logits"] = logits.numpy()
        result[f"{tag}_loss"] = np.asarray(float(loss))
        for i, p in enumerate(model.parameters()):
            result[f"{tag}_param{i}"] = p.detach().numpy()
    result["part"] = part.numpy()
    return result


def ragged_case(ring) -> dict:
    """``gather_sizes`` and ``all_gather_variable`` of rank r's first
    ``(r + 1) % 4`` rows of 3 (every process gets the same result)."""
    data = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4 * 3, 2)
    shards = [torch.from_numpy(data[r * 3:(r + 1) * 3]) for r in ring.ranks]
    lengths = [(1 + r) % 4 for r in ring.ranks]
    gathered, mask = all_gather_variable(shards, lengths, ring)
    return dict(sizes=gather_sizes(lengths, ring).numpy(), gathered=gathered.numpy(),
                mask=mask.numpy(), dense=compact_masked(gathered, mask).numpy())


def _run(cases, rank, store_path, out_dir):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                                rank=rank, world_size=WORLD)
        for name, fn in cases():
            np.savez(f"{out_dir}/{name}_{rank}.npz", **fn())
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def run_variants(rank, store_path, out_dir):
    """Worker: each variant on a ``DistributedRing`` of the four processes."""
    def cases():
        ring = create_mesh().ring
        return [(name, lambda name=name: variant_case(ring, name)) for name in VARIANT_CASES]

    _run(cases, rank, store_path, out_dir)


def run_batches(rank, store_path, out_dir):
    """Worker: each process-local batch case on its mesh of the four
    processes (every process builds every mesh, in the same order)."""
    def cases():
        meshes = {name: create_mesh(**mesh_kw) for name, (mesh_kw, _) in BATCH_CASES.items()}
        ring = create_mesh().ring
        return [(name, lambda name=name: batch_case(meshes[name], name))
                for name in BATCH_CASES] + [("ragged", lambda: ragged_case(ring))]

    _run(cases, rank, store_path, out_dir)

