"""Parity: the model on the int8 ring, port vs JAX package, on the CPU.

``RingTransformer(ring_hop_compression="int8", compute_dtype="int8")`` (2
layers, dim 64, GQA 4/2) on ``create_mesh(ring_size=4)`` against the JAX
model on its 2x4 CPU mesh (``impl="pallas"``, the Pallas kernels in
interpret mode, the same weights through ``weights.py``), with
``impl="cuda"`` (the scan ring's B4 hops fed the payload) and
``impl="fused"`` (the fused ring; its kernel wrappers run their plain
versions on CPU tensors): logits within ``OUT_REL_TOL`` norm-relative (the
same int8 function; a rare p8 unit flip), and the loss after one Adam step
(optax on the JAX side) within 1e-4 relative; with ``segment_ids`` and
with ``mask=Causal() & DocumentMask(starts)`` (the ring realizes the
packing as runtime ids).  The fused model without ids takes the remote
tier (one v block per rank span, JAX ``ring.py:719``), which JAX's CPU path
does not reach: it is held to the JAX float model within
``Q8_FWD_REL_L2``, the JAX package's own bound for an int8 forward
(``tests/test_quant.py``).
"""

import functools

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
from ring_attention_tpu_torch import RingTransformer, load_jax_params
from ring_attention_tpu_torch.masks import Causal, DocumentMask
from ring_attention_tpu_torch.parallel import create_mesh

OUT_REL_TOL = 1e-3  # test_torch_q8.py: the same int8 function
Q8_FWD_REL_L2 = 2e-2  # tests/test_quant.py: an int8 forward against the float one


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              bucket_size=16, compute_dtype="int8", ring_hop_compression="int8")
STARTS = (0, 40, 72, 100)
MODEL_FORMS = {"plain": {}, "segments": {}, "doc_mask": {}}


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _ids(b=2, n=128):
    ids = np.searchsorted(np.asarray(STARTS), np.arange(n), side="right") - 1
    return np.broadcast_to(ids.astype(np.int32), (b, n)).copy()


@functools.cache
def _jax_model(form, int8=True):
    kw = dict(causal=True)
    if form == "doc_mask":
        kw = dict(mask=JaxCausal() & JaxDocumentMask(STARTS))
    if not int8:  # the exact float model, on the same weights
        kw.update(compute_dtype=None, ring_hop_compression=None)
    jm = JaxTransformer(**{**CONFIG, **kw}, impl="pallas",
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
    return jm, jax.tree_util.tree_map(np.asarray, params)


@functools.cache
def _jax_logits_and_step(form, int8=True):
    """Logits, and the loss after one Adam step (optax, lr 1e-3)."""
    jm, params = _jax_model(form, int8)
    tokens = jnp.asarray(_tokens(1))
    seg = jnp.asarray(_ids()) if form == "segments" else None

    def loss_fn(p):
        return jm.apply(p, tokens, return_loss=True, segment_ids=seg)

    logits = jax.jit(lambda p: jm.apply(p, tokens, segment_ids=seg))(params)
    opt = optax.adam(1e-3)
    loss_jit = jax.jit(loss_fn)
    grads = jax.jit(jax.grad(loss_fn))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = optax.apply_updates(params, updates)
    return np.asarray(logits), float(loss_jit(stepped))


@pytest.mark.parametrize("impl", ["cuda", "fused"])
@pytest.mark.parametrize("form", list(MODEL_FORMS))
def test_int8_ring_model_equals_jax(form, impl):
    _, params = _jax_model(form)
    # the fused ring without ids takes its remote tier (one v block per rank
    # span), which JAX's CPU path does not: held to the exact float model
    remote = impl == "fused" and form == "plain"
    ref_logits, ref_loss = _jax_logits_and_step(form, not remote)
    kw = dict(causal=True)
    if form == "doc_mask":
        kw = dict(mask=Causal() & DocumentMask(STARTS))
    tm = load_jax_params(RingTransformer(**CONFIG, **kw, impl=impl, device="cpu",
                                         mesh=create_mesh(ring_size=4)), params)
    tokens = torch.from_numpy(_tokens(1))
    seg = torch.from_numpy(_ids()) if form == "segments" else None
    with torch.no_grad():
        logits = tm(tokens, segment_ids=seg)
    rel = _rel(logits.numpy(), ref_logits)
    print(f"{form} {impl}: ||logits - jax|| / ||jax|| {rel:.2e}")
    assert rel <= (Q8_FWD_REL_L2 if remote else OUT_REL_TOL)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    opt.zero_grad()
    tm(tokens, return_loss=True, segment_ids=seg).backward()
    opt.step()
    with torch.no_grad():
        loss = float(tm(tokens, return_loss=True, segment_ids=seg))
    np.testing.assert_allclose(loss, ref_loss, rtol=Q8_FWD_REL_L2 if remote else 1e-4)
