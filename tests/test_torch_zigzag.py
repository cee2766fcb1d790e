"""Parity: the port's zig-zag context parallelism vs the JAX package's.

The JAX side runs ``zigzag_attention`` under ``shard_map`` on
``create_mesh(ring_size=4)`` of the 8 virtual CPU devices (a 2 x 4 mesh),
as ``tests/test_zigzag.py`` does, with ``impl="xla"`` and ``impl="pallas"``
(interpret mode on the CPU); the port's on a ``VirtualRing`` of 4 in this
process, ``impl="torch"`` held to ``"xla"`` and ``impl="cuda"`` (whose
kernel wrappers run their plain versions on CPU tensors) to ``"pallas"``.
The same numpy inputs go through both: the permutations and positions
(exactly), the attention's output and its gradients (GQA, a bucket that
does not divide the gathered length, packed segment ids with softclamp),
and the zig-zag ``RingTransformer``'s logits, loss and every parameter
gradient (weights carried over with ``load_jax_params``).  Each JAX
reference is computed once (``functools.cache``).

Tolerances: outputs 1e-5 absolute; gradients ``GRAD_TOL`` of
``tests/test_torch_ring_model.py`` (2e-5 absolute plus 1e-4 relative);
the model's loss 1e-5 relative.
"""

import copy
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import zigzag as jax_zigzag
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import RingTransformer, export_jax_params, load_jax_params
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    zigzag_attention,
    zigzag_permute,
    zigzag_positions,
    zigzag_unpermute,
)

RING = 4
OUT_ATOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
JAX_IMPL = {"torch": "xla", "cuda": "pallas"}
# name: (b, h, hk, n, d, bucket_size, segment ids, softclamp)
CASES = {
    "gqa_bucket16": (2, 4, 2, 128, 16, 16, False, None),
    # 80 tokens: chunks of 10; the bucket fits to 40, a divisor of 80
    "odd_bucket": (2, 4, 4, 80, 16, 64, False, None),
    "segments_softclamp": (2, 4, 2, 128, 16, 16, True, 5.0),
}


def _inputs(case, seed=0):
    b, h, hk, n, d, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    # three documents a row, boundaries inside chunks and across ranks
    seg = np.repeat(np.int32([0, 1, 2]), [n // 4 + 5, n // 3, n - n // 4 - 5 - n // 3])
    seg = seg[None].repeat(b, 0)
    return q, k, v, seg, do


@functools.cache
def _jax_reference(case, impl):
    """Output and (dq, dk, dv) of the JAX zig-zag on the 2 x 4 mesh."""
    *_, bucket, packed, clamp = CASES[case]
    q, k, v, seg, do = (jnp.asarray(x) for x in _inputs(case))
    mesh = jax_create_mesh(ring_size=RING)
    spec = P("data", None, "seq", None)
    segz = jax_zigzag.zigzag_permute(seg, RING, axis=1) if packed else None

    def run(q, k, v):
        qz, kz, vz = (jax_zigzag.zigzag_permute(x, RING, axis=2) for x in (q, k, v))

        def core(q, k, v, *ids):
            return jax_zigzag.zigzag_attention(
                q, k, v, "seq", bucket_size=bucket, softclamp_value=clamp,
                impl=impl, segment_ids=ids[0] if ids else None,
            )

        args, specs = (qz, kz, vz), (spec,) * 3
        if packed:
            args, specs = args + (segz,), specs + (P("data", "seq"),)
        out = shard_map(core, mesh=mesh, in_specs=specs, out_specs=spec,
                        check_vma=impl != "pallas")(*args)
        return jax_zigzag.zigzag_unpermute(out, RING, axis=2)

    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(run, q, k, v)
        return out, vjp(do)

    out, grads = jax.jit(out_and_grads)(q, k, v, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(case, impl, ring=None):
    *_, bucket, packed, clamp = CASES[case]
    q, k, v, seg, do = _inputs(case)
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    xz = [zigzag_permute(a, RING, axis=2) for a in x]
    segz = zigzag_permute(torch.from_numpy(seg), RING, axis=1) if packed else None
    out = zigzag_attention(*xz, ring or VirtualRing(RING), bucket_size=bucket,
                           softclamp_value=clamp, impl=impl, segment_ids=segz)
    out = zigzag_unpermute(out, RING, axis=2)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [a.grad.numpy() for a in x]


@pytest.mark.parametrize("ring_size", [1, 2, 4, 8])
@pytest.mark.parametrize("axis", [1, 2])
def test_permutations_equal_jax(ring_size, axis):
    x = np.arange(2 * 3 * 48 * 5).reshape(2, 3, 48, 5) if axis == 2 else \
        np.arange(2 * 48 * 3).reshape(2, 48, 3)
    t = torch.from_numpy(x)
    for port, jax_fn in ((zigzag_permute, jax_zigzag.zigzag_permute),
                         (zigzag_unpermute, jax_zigzag.zigzag_unpermute)):
        np.testing.assert_array_equal(port(t, ring_size, axis=axis).numpy(),
                                      np.asarray(jax_fn(jnp.asarray(x), ring_size, axis=axis)))
    assert torch.equal(zigzag_unpermute(zigzag_permute(t, ring_size, axis), ring_size, axis), t)


@pytest.mark.parametrize("ring_size", [1, 2, 4, 8])
def test_positions_equal_jax(ring_size):
    n_local = 12
    for rank in range(ring_size):
        np.testing.assert_array_equal(
            zigzag_positions(n_local, rank, ring_size).numpy(),
            np.asarray(jax_zigzag.zigzag_positions(n_local, rank, ring_size)))
    every = torch.cat([zigzag_positions(n_local, r, ring_size) for r in range(ring_size)])
    assert torch.equal(every.sort().values, torch.arange(ring_size * n_local))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_zigzag_attention_and_grads_match_jax(case, impl):
    ref_out, ref_grads = _jax_reference(case, JAX_IMPL[impl])
    out, grads = _port(case, impl)
    np.testing.assert_allclose(out, ref_out, atol=OUT_ATOL)
    for label, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, err_msg=label, **GRAD_TOL)


def test_zigzag_checks_and_budget_warning():
    q, k, v, _, _ = (torch.from_numpy(a) for a in _inputs("gqa_bucket16"))
    ring = VirtualRing(RING)
    with pytest.raises(ValueError, match="causal only"):
        zigzag_attention(q, k, v, ring, causal=False)
    with pytest.raises(ValueError, match="impl must be one of"):
        zigzag_attention(q, k, v, ring, impl="fused")
    with pytest.raises(ValueError, match="two equal chunks"):
        zigzag_attention(q[:, :, :124], k[:, :, :124], v[:, :, :124], ring)
    with pytest.raises(ValueError, match="must divide into 8 chunks"):
        zigzag_permute(q, RING, axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the default budget: no warning at 128 tokens
        zigzag_attention(q, k, v, ring)
    with pytest.warns(UserWarning, match="sequence_parallel='ring'"):
        zigzag_attention(q, k, v, ring, gathered_kv_budget=1024)


# --- the zig-zag RingTransformer --------------------------------------------

CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, bucket_size=16, sequence_parallel="zigzag")


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_model():
    jm = JaxTransformer(**CONFIG, mesh=jax_create_mesh(ring_size=RING, data_size=2))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0))))
    tokens = jnp.asarray(_tokens(1))  # 127 positions after the label shift
    logits = np.asarray(jax.jit(jm.apply)(params, tokens[:, :-1]))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, tokens, return_loss=True)))(params)
    return params, logits, float(loss), grads


def _grads_as_jax(model):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return export_jax_params(holder)


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
def test_zigzag_model_logits_loss_and_grads_match_jax(impl):
    """The 127-token rows pad to 128 = 2 x 4 chunks x 16 at the model top;
    ``"fused"`` runs zig-zag as ``"cuda"``."""
    params, ref_logits, ref_loss, ref_grads = _jax_model()
    tm = load_jax_params(RingTransformer(**CONFIG, impl=impl, device="cpu",
                                         mesh=create_mesh(ring_size=RING)), params)
    tokens = torch.from_numpy(_tokens(1))
    with torch.no_grad():
        np.testing.assert_allclose(tm(tokens[:, :-1]).numpy(), ref_logits, atol=1e-4)
    loss = tm(tokens, return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(_grads_as_jax(tm)))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(r), err_msg=str(path),
                                   **GRAD_TOL)


def test_zigzag_model_checks():
    """The JAX layer's zig-zag asserts, as one-line errors at construction."""
    mesh = create_mesh(ring_size=RING)
    base = dict(CONFIG, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="causal only"):
        RingTransformer(**dict(base, causal=False))
    with pytest.raises(ValueError, match="max_lookback_seq_len"):
        RingTransformer(**base, max_lookback_seq_len=8)
    with pytest.raises(ValueError, match='supports the "ring" strategy'):
        RingTransformer(**base, compute_dtype="int8")
