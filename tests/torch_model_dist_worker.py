"""Cases and the worker of ``tests/test_torch_model_dist.py``: the model on a
mesh of gloo processes.  This module imports no JAX, so that each spawned
process starts on torch and the port alone."""

import traceback

import numpy as np
import torch

from ring_attention_tpu_torch import (
    RingAttention,
    RingTransformer,
    init_step_stats,
    make_train_step,
)
from ring_attention_tpu_torch.masks import Causal, DocumentMask
from ring_attention_tpu_torch.parallel import create_mesh, mesh_all_reduce

WORLD = 4
JOIN_TIMEOUT_S = 120
CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, bucket_size=16)
STARTS = (0, 40, 72, 100)
# name: (ring size, or (outer ring size, ulysses size) of a factored mesh,
# data size, model kwargs, packed ids given)
CASES = {
    "torch": (4, 1, dict(impl="torch"), False),
    "cuda": (4, 1, dict(impl="cuda"), False),
    "fused": (4, 1, dict(impl="fused"), False),
    "torch_striped": (4, 1, dict(impl="torch", striped=True), False),
    "cuda_striped": (4, 1, dict(impl="cuda", striped=True), False),
    "fused_striped": (4, 1, dict(impl="fused", striped=True), False),
    "data2_ring2": (2, 2, dict(impl="cuda", striped=True), False),
    "segment_ids": (4, 1, dict(impl="cuda"), True),
    "doc_mask": (4, 1, dict(impl="cuda", causal=False,
                            mask=Causal() & DocumentMask(STARTS)), False),
    "zigzag": (4, 1, dict(impl="cuda", sequence_parallel="zigzag"), False),
    "int8": (4, 1, dict(impl="cuda", compute_dtype="int8",
                        ring_hop_compression="int8"), False),
    # the memory knobs: under nothing_saveable the backward reruns each
    # layer's ring, its gloo rotations in the same order on every process
    "remat_nothing_saveable": (4, 1, dict(impl="cuda", striped=True, remat=True,
                                          remat_policy="nothing_saveable",
                                          ff_chunk_size=12, loss_chunk_size=40), False),
    "remat_save_attn": (2, 2, dict(impl="cuda", remat=True, remat_policy="save_attn",
                                   ff_chunk_size=20, loss_chunk_size=24), False),
    # Ulysses over the ring of 4 (small-hk GQA: 4 heads, 2 kv heads) and the
    # hybrid strategy on ring 2 x ulysses 2: the all-to-alls cross the
    # processes, the gradient sums over the ulysses group too
    "ulysses": (4, 1, dict(impl="cuda", sequence_parallel="ulysses"), False),
    "hybrid": ((2, 2), 1, dict(impl="cuda", striped=True, sequence_parallel="hybrid"), True),
}
# three SGD steps: name -> (ring size, data size)
STEP_CASES = {"steps_ring4": (4, 1), "steps_data2_ring2": (2, 2)}
LR, CLIP, STEP_SEEDS = 0.5, 1.0, (3, 4, 5)
# ZeRO-1: two Adam steps on data 2 x ring 2, name -> make_train_step options
ZERO_CASES = {"zero1_plain": {}, "zero1": dict(shard_opt_state=True),
              "zero1_offload": dict(shard_opt_state=True, offload_opt_state=True)}
ZERO_LR = 1e-2
# decoding: name -> (ring size, data size, quantize_cache)
SERVE_CASES = {"serve_plain": (4, 1, False), "serve_quantized": (4, 1, True),
               "serve_data2_ring2": (2, 2, False)}
MAX_LEN, PROMPT, STEPS = 24, 10, 6
# the attention layer's own auto_shard path: name -> (ring size, data size)
LAYER_CASES = {"layer_ring4": (4, 1), "layer_data2_ring2": (2, 2)}
LAYER = dict(dim=32, heads=4, dim_head=8, kv_heads=2, striped=True, auto_shard=True,
             bucket_size=4)


def mesh_kw(ring) -> dict:
    """``create_mesh`` arguments of a case's ring entry."""
    if isinstance(ring, tuple):
        return dict(ring_size=ring[0], ulysses_size=ring[1])
    return dict(ring_size=ring)


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int64)


def _ids(b=2, n=128):
    ids = np.searchsorted(np.asarray(STARTS), np.arange(n), side="right") - 1
    return np.broadcast_to(ids.astype(np.int64), (b, n)).copy()


def _model(mesh, state, **kw):
    model = RingTransformer(**{**CONFIG, **kw}, device="cpu", mesh=mesh)
    model.load_state_dict(state)
    return model


def _model_case(mesh, state, name):
    """Global logits, the loss and the mesh-summed gradient of every
    parameter, for one case on this mesh."""
    _, _, kw, packed = CASES[name]
    model = _model(mesh, state, **kw)
    ids = torch.from_numpy(_ids()) if packed else None
    with torch.no_grad():
        logits = model(torch.from_numpy(_tokens(2)[:, :127]),
                       segment_ids=None if ids is None else ids[:, :127])
    loss = model(torch.from_numpy(_tokens(1)), return_loss=True, segment_ids=ids)
    loss.backward()
    grads = mesh_all_reduce(mesh, [p.grad for p in model.parameters()])
    return [logits.numpy(), loss.detach().numpy()] + [g.numpy() for g in grads]


def _steps(mesh, state, summed=True, seeds=STEP_SEEDS):
    """The losses of SGD steps with clipping and the non-finite guard, then
    every parameter; ``summed=False`` builds the step without the mesh."""
    model = _model(mesh, state, impl="cuda", striped=True)
    step = make_train_step(lambda t: model(t, return_loss=True),
                           torch.optim.SGD(model.parameters(), lr=LR),
                           clip_grad_norm=CLIP, skip_nonfinite=True,
                           mesh=mesh if summed else None)
    stats, losses = init_step_stats(), []
    for seed in seeds:
        stats, loss = step(stats, torch.from_numpy(_tokens(seed)))
        assert stats.step_ok
        losses.append(float(loss))
    return [np.asarray(losses)] + [p.detach().numpy() for p in model.parameters()]


def _zero_steps(mesh, state, name):
    """Two clipped Adam steps with ZERO_CASES' options: the optimizer-state
    elements the process holds (its moments, Adam's step counts apart),
    then every parameter."""
    model = _model(mesh, state, impl="cuda", striped=True)
    opt = torch.optim.Adam(model.parameters(), lr=ZERO_LR)
    step = make_train_step(lambda t: model(t, return_loss=True), opt, clip_grad_norm=CLIP,
                           mesh=mesh, **ZERO_CASES[name])
    for seed in STEP_SEEDS[:2]:
        step(torch.from_numpy(_tokens(seed)))
    moments = sum(v.numel() for st in opt.state.values()
                  for key, v in st.items() if key != "step")
    return [np.asarray(moments)] + [p.detach().numpy() for p in model.parameters()]


def _serve(mesh, state, quantize):
    """Prefill's and each teacher-forced decode step's logits, greedy
    tokens, and tokens sampled from a seeded generator."""
    model = _model(mesh, state, impl="cuda", quantize_cache=quantize)
    tokens = torch.from_numpy(_tokens(6, n=PROMPT + STEPS))
    with torch.no_grad():
        cache = model.init_cache(2, MAX_LEN)
        logits, cache = model.prefill(tokens[:, :PROMPT], cache)
        steps = [logits]
        for pos in range(PROMPT, PROMPT + STEPS - 1):
            logits, cache = model.decode_step(tokens[:, pos], cache, pos)
            steps.append(logits)
    greedy = model.generate(tokens[:, :PROMPT], MAX_LEN, STEPS)
    sampled = model.generate(tokens[:, :PROMPT], MAX_LEN, STEPS, temperature=1.0,
                             top_k=50, generator=torch.Generator().manual_seed(7))
    return [torch.stack(steps).numpy(), greedy.numpy(), sampled.numpy()]


def _layer_case(mesh):
    """The attention layer's own pad -> permute -> cut -> ring -> gather
    path on a non-causal 29-token input with a key mask: the global output,
    the mesh's sum of the parameters' gradients under a loss that every
    process computes alike on that output, then a causal copy's ``prefill``
    of a 10-token prompt: its global output and every cache shard the
    process holds."""
    torch.manual_seed(1)
    layer = RingAttention(**LAYER, device="cpu", mesh=mesh)
    rng = np.random.default_rng(7)
    x, w = (torch.from_numpy(rng.standard_normal((2, 29, 32)).astype(np.float32))
            for _ in range(2))
    mask = torch.from_numpy(rng.random((2, 29)) > 0.3)
    out = layer(x, mask)
    (out * w).sum().backward()
    grads = mesh_all_reduce(mesh, [p.grad for p in layer.parameters()])
    causal = RingAttention(**LAYER, causal=True, device="cpu", mesh=mesh)
    causal.load_state_dict(layer.state_dict())
    rows = 2 // mesh.data
    cache_k, cache_v = ([torch.zeros(rows, 2, 16 // mesh.seq, 8) for _ in mesh.ring.ranks]
                        for _ in range(2))
    with torch.no_grad():
        prefill, _, _ = causal.prefill(x[:, :10], cache_k, cache_v)
    return ([out.detach().numpy()] + [g.numpy() for g in grads] + [prefill.numpy()]
            + [c.numpy() for c in cache_k + cache_v])


def _worker(rank, store_path, out_dir):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                                rank=rank, world_size=WORLD)
        meshes = {(4, 1): create_mesh(), (2, 2): create_mesh(ring_size=2, data_size=2),
                  ((2, 2), 1): create_mesh(ring_size=2, ulysses_size=2)}
        state = torch.load(f"{out_dir}/weights.pt")
        for name, (ring, data, _, _) in CASES.items():
            np.savez(f"{out_dir}/{name}_{rank}.npz",
                     *_model_case(meshes[ring, data], state, name))
        for name, (ring, data) in STEP_CASES.items():
            np.savez(f"{out_dir}/{name}_{rank}.npz", *_steps(meshes[ring, data], state))
        np.savez(f"{out_dir}/unsummed_{rank}.npz",
                 *_steps(meshes[4, 1], state, summed=False, seeds=STEP_SEEDS[:1]))
        for name in ZERO_CASES:
            np.savez(f"{out_dir}/{name}_{rank}.npz", *_zero_steps(meshes[2, 2], state, name))
        for name, (ring, data, quantize) in SERVE_CASES.items():
            np.savez(f"{out_dir}/{name}_{rank}.npz",
                     *_serve(meshes[ring, data], state, quantize))
        for name, (ring, data) in LAYER_CASES.items():
            np.savez(f"{out_dir}/{name}_{rank}.npz", *_layer_case(meshes[ring, data]))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise
