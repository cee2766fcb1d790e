"""Parity: the port's Ulysses sequence parallelism vs the JAX package's.

The JAX side runs ``ulysses_attention`` under ``shard_map`` on
``create_mesh(ring_size=8)`` of the 8 virtual CPU devices, as
``tests/test_ulysses.py`` does; the port's on a ``VirtualRing`` of 8 in
this process (the held ranks' head blocks folded into one batch), with
``impl="torch"`` and ``impl="cuda"`` (whose kernel wrappers run their plain
versions on CPU tensors) both held to the JAX ``impl="xla"`` function, and
``"cuda"`` to ``"pallas"`` (interpret mode) in one case.  The same numpy
inputs go through both: outputs causal and not, GQA with ``hk == W``,
gradients, the head divisibility error (JAX's words, a ``ValueError``),
small-hk GQA (``hk`` 2 and 4 over 8) with its gradients summed over the
copies, and the pin the failing JAX audit
(``test_ulysses_gqa_no_repeated_all_to_all``) meant: small-hk K/V move once,
two all-gathers and no all-to-all of repeated heads, read from the ring's
``calls``.  At the model level the Ulysses ``RingTransformer`` on a ring of
4 against the JAX model on its 2 x 4 mesh (logits, loss, every gradient),
and a declared packing (``mask=Causal() & DocumentMask(...)``, which Ulysses
hands its kernels as ``doc_starts``) against the JAX model.  Each JAX
reference is computed once (``functools.cache``).

Tolerances: outputs 2e-5 absolute (JAX's ``ATOL``); gradients ``GRAD_TOL``
of ``tests/test_torch_ring_model.py`` (2e-5 absolute plus 1e-4 relative);
logits 1e-4 absolute; the loss 1e-5 relative.
"""

import copy
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.masks import Causal as JaxCausal
from ring_attention_tpu.masks import DocumentMask as JaxDocumentMask
from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import RingTransformer, export_jax_params, load_jax_params
from ring_attention_tpu_torch.masks import Causal, DocumentMask
from ring_attention_tpu_torch.parallel import VirtualRing, create_mesh
from ring_attention_tpu_torch.parallel.ulysses import kv_head_reshard, ulysses_attention

WORLD = 8
ATOL = 2e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
JAX_IMPL = {"torch": "xla", "cuda": "pallas"}
# name: (h, hk, causal); b 2, n 128, d 16, bucket 16 as in tests/test_ulysses.py
CASES = {
    "plain": (8, 8, False),
    "causal": (8, 8, True),
    "gqa_hk_eq_world": (16, 8, True),
    "small_hk2": (16, 2, True),
    "small_hk4": (16, 4, True),
}


def _inputs(case, b=2, n=128, d=16):
    h, hk, _ = CASES[case]
    rng = np.random.default_rng(0)
    q, do = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@functools.cache
def _jax_reference(case, impl="xla"):
    """Output and (dq, dk, dv) of the JAX Ulysses on the 8-device mesh."""
    causal = CASES[case][2]
    q, k, v, do = (jnp.asarray(x) for x in _inputs(case))
    mesh = jax_create_mesh(ring_size=WORLD)
    spec = P("data", None, "seq", None)
    run = shard_map(partial(jax_ulysses, axis_name="seq", causal=causal, bucket_size=16,
                            impl=impl),
                    mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                    check_vma=impl != "pallas")

    def out_and_grads(q, k, v, do):
        out, vjp = jax.vjp(run, q, k, v)
        return out, vjp(do)

    out, grads = jax.jit(out_and_grads)(q, k, v, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(case, impl, ring=None):
    causal = CASES[case][2]
    q, k, v, do = _inputs(case)
    x = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ulysses_attention(*x, ring or VirtualRing(WORLD), causal=causal, bucket_size=16,
                            impl=impl)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [a.grad.numpy() for a in x]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_ulysses_attention_and_grads_match_jax(case, impl):
    """Parity causal and not, GQA with hk == W, and small-hk GQA (hk 2 and
    4 over 8): outputs and dq, dk, dv (dk/dv summed over the local copies
    and the gather's ranks)."""
    ref_out, ref_grads = _jax_reference(case)
    out, grads = _port(case, impl)
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    for label, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, err_msg=label, **GRAD_TOL)


def test_ulysses_cuda_matches_pallas():
    """``impl="cuda"`` against the JAX Ulysses on its Pallas kernels
    (interpret mode): the causal case, output and gradients."""
    ref_out, ref_grads = _jax_reference("causal", "pallas")
    out, grads = _port("causal", "cuda")
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    for label, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(g, r, err_msg=label, **GRAD_TOL)


def test_ulysses_head_divisibility():
    """4 query heads over 8 ranks: JAX's assertion, as a ValueError with its
    words."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 4, 128, 16)).astype(np.float32) for _ in range(3))
    mesh = jax_create_mesh(ring_size=WORLD)
    spec = P("data", None, "seq", None)
    with pytest.raises(AssertionError) as jax_err:
        shard_map(partial(jax_ulysses, axis_name="seq", causal=True), mesh=mesh,
                  in_specs=(spec,) * 3, out_specs=spec)(*map(jnp.asarray, (q, k, v)))
    with pytest.raises(ValueError) as err:
        ulysses_attention(*map(torch.from_numpy, (q, k, v)), VirtualRing(WORLD), causal=True)
    assert str(jax_err.value) in str(err.value)
    with pytest.raises(ValueError, match="impl must be one of"):
        ulysses_attention(*map(torch.from_numpy, (q, k, v)), VirtualRing(2), impl="fused")


@pytest.mark.parametrize("case", ["gqa_hk_eq_world", "small_hk2", "small_hk4"])
def test_ulysses_moves_kv_once(case):
    """What ``tests/test_ulysses.py::test_ulysses_gqa_no_repeated_all_to_all``
    pins in the JAX HLO (it fails in the JAX package itself): with hk % W !=
    0 the real kv heads move once, one all-gather each for k and v, and only
    q and the output take the all-to-all; with hk % W == 0, q, k, v and the
    output take one all-to-all each and nothing is gathered."""
    ring = VirtualRing(WORLD)
    q, k, v, _ = map(torch.from_numpy, _inputs(case))
    ulysses_attention(q, k, v, ring, causal=True, impl="torch")
    hk = CASES[case][1]
    want = ({"all_to_all": 4, "all_gather": 0} if hk % WORLD == 0
            else {"all_to_all": 2, "all_gather": 2})
    assert {op: ring.calls[op] for op in want} == want
    assert ring.calls["rotate"] == ring.calls["all_reduce"] == 0


def test_kv_head_reshard_heads():
    """Each rank's kv block: a slice of one head where the query heads of a
    rank share one (16 heads over hk 2 on 8 ranks: ranks 0-3 head 0), one
    copy per query head where the groups do not align (12 over hk 3 on 4
    ranks: rank 1 holds query heads 3-5, kv heads 0, 1, 1)."""
    k = torch.arange(2).repeat_interleave(8 * 4).view(1, 2, 32, 1).float()
    kh, _ = kv_head_reshard(k, k, VirtualRing(WORLD), 16)
    assert kh.shape == (8, 1, 32, 1)
    assert kh[:, 0, 0, 0].tolist() == [0] * 4 + [1] * 4
    k = torch.arange(3).repeat_interleave(16).view(1, 3, 16, 1).float()
    kh, _ = kv_head_reshard(k, k, VirtualRing(4), 12)
    assert kh.shape == (4, 3, 16, 1)
    assert kh[1, :, 0, 0].tolist() == [0, 1, 1]


# --- the Ulysses RingTransformer --------------------------------------------

CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, bucket_size=16, sequence_parallel="ulysses")
STARTS = (0, 40, 72, 100)


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_model(form):
    """Params, logits (127 positions), loss and gradients of the JAX
    Ulysses model on the 2 x 4 mesh; ``"doc_mask"`` with a declared
    packing."""
    kw = (dict(causal=False, mask=JaxCausal() & JaxDocumentMask(STARTS))
          if form == "doc_mask" else {})
    jm = JaxTransformer(**{**CONFIG, **kw}, mesh=jax_create_mesh(ring_size=4, data_size=2))
    params = jax.tree_util.tree_map(
        np.asarray, JaxTransformer(**CONFIG).init(jax.random.PRNGKey(0),
                                                  jnp.asarray(_tokens(0))))
    tokens = jnp.asarray(_tokens(1))

    @jax.jit
    def run(p):
        logits = jm.apply(p, tokens[:, :-1])
        return logits, jax.value_and_grad(lambda p: jm.apply(p, tokens, return_loss=True))(p)

    logits, (loss, grads) = run(params)
    return params, np.asarray(logits), float(loss), grads


def _grads_as_jax(model):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return export_jax_params(holder)


@pytest.mark.parametrize("form,impl", [("plain", "torch"), ("plain", "cuda"),
                                       ("plain", "fused"), ("doc_mask", "cuda")])
def test_ulysses_model_matches_jax(form, impl):
    """The 127-token rows pad to 128 over a ring of 4 (small-hk GQA: 4
    heads, 2 kv heads); ``"fused"`` runs Ulysses as ``"cuda"``, as the JAX
    layer's ``_use_pallas`` does; the declared packing reaches the local
    kernels as ``doc_starts`` where the JAX model realizes it as runtime
    ids."""
    params, ref_logits, ref_loss, ref_grads = _jax_model(form)
    kw = dict(causal=False, mask=Causal() & DocumentMask(STARTS)) if form == "doc_mask" else {}
    tm = load_jax_params(RingTransformer(**{**CONFIG, **kw}, impl=impl, device="cpu",
                                         mesh=create_mesh(ring_size=4)), params)
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


def test_ulysses_model_checks():
    """Ulysses never stripes (``striped=True`` gives the same logits), takes
    no int8 compute on a mesh (JAX ``_compute_dtype``) and runs on a plain
    mesh only."""
    mesh = create_mesh(ring_size=4)
    base = dict(CONFIG, device="cpu", num_tokens=64, dim=32, heads=4, dim_head=8)
    torch.manual_seed(0)
    plain = RingTransformer(**base, mesh=mesh)
    striped = RingTransformer(**base, mesh=mesh, striped=True)
    striped.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(_tokens(2, n=30)) % 64
    with torch.no_grad():
        assert torch.equal(plain(tokens), striped(tokens))
    with pytest.raises(ValueError, match='sequence_parallel="ulysses"'):
        RingTransformer(**base, mesh=mesh, compute_dtype="int8")
    with pytest.raises(ValueError, match="plain"):
        RingTransformer(**base, mesh=create_mesh(ring_size=2, ulysses_size=2))
