"""Parity: the port's fused ring (``impl="fused"``) vs the JAX fused ring.

The same numpy inputs go through the JAX package and the port, on the CPU:

- the hop tables: ``parallel/ring.py::_fused_tables`` of the port equal the
  JAX ones exactly, for every rank of rings of 1-4, causal or not, striped
  or not, windowed, with limited passes;
- the kernel function: ``ops/cuda_ring.py::fused_ring_local`` on CPU
  tensors (its plain version, the port's hop chain) against
  ``ops/pallas_ring.py::fused_ring_local(..., interpret=True)`` with the
  same tables, out and lse to ``test_ring.py``'s ``ATOL = 2e-5``;
- the ring: ``ring_flash_attention(impl="fused")`` on a ``VirtualRing``
  against the JAX ``ring_flash_attention(impl="fused")`` under
  ``shard_map`` on the 8-device mesh, forward to ``ATOL`` and dq/dk/dv to
  ``GRAD_ATOL = 5e-4``; and against the port's own ``impl="cuda"`` ring,
  bit for bit (the same plain arithmetic in the same order on the CPU);
- the model: ``RingTransformer(mesh=create_mesh(ring_size=4),
  impl="fused")`` with the JAX weights against the JAX model with
  ``impl="fused"`` on its (data 2, ring 4) mesh: logits, loss, every
  gradient and three SGD steps (``test_torch_ring_model.py``'s
  tolerances).  On the CPU the JAX model's resolver records a
  ``fused_ring`` degradation and runs its scan-path ring; the degradation
  state is reset around it, as ``tests/test_fused_ring.py`` does.
"""

import copy
import functools
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.ops import pallas_ring as jpr
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring as jring
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.parallel import sharding as jsharding
from ring_attention_tpu.utils import resilience
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu.utils.train import make_train_step as jax_make_train_step
from ring_attention_tpu_torch import (
    RingTransformer,
    export_jax_params,
    load_jax_params,
    make_train_step,
)
from ring_attention_tpu_torch.ops import cuda_ring
from ring_attention_tpu_torch.parallel import (
    VirtualRing,
    create_mesh,
    ring_flash_attention,
    stripe_permute,
    stripe_unpermute,
)
from ring_attention_tpu_torch.parallel import ring as pring

ATOL = 2e-5
GRAD_ATOL = 5e-4
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the hop tables
# ---------------------------------------------------------------------------

BANDS = {
    "full": (False, False, None),
    "causal": (True, False, None),
    "striped": (True, True, None),
    "window3": (True, False, 3),
    "window40": (True, False, 40),
    "striped_window3": (True, True, 3),
    "striped_window40": (True, True, 40),
}


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("ring_size", [1, 2, 3, 4])
def test_fused_tables_equal_jax(ring_size, band):
    """Every rank and every pass count: origins, his, los and works."""
    causal, striped, window = BANDS[band]
    n = 16
    for passes in range(1, ring_size + 1):
        for rank in range(ring_size):
            geo = (rank, passes, n, causal, striped, window, ring_size)
            got = pring._fused_tables(*geo)
            ref = jring._fused_tables(*geo)
            for name, g, r in zip(("origins", "his", "los", "works"), got, ref):
                assert g.dtype == torch.int32, name
                assert g.tolist() == np.asarray(r).tolist(), (name, rank, passes)


def test_fitted_blocks_equal_jax():
    for n, bq, bk in ((16, None, None), (48, 32, 32), (4096, 512, None), (1000, 64, 128)):
        assert cuda_ring.fitted_blocks(n, bq, bk) == jpr.fitted_blocks(n, bq, bk)


# ---------------------------------------------------------------------------
# (b) the kernel function: plain version vs the Pallas kernel, interpret mode
# ---------------------------------------------------------------------------

# name: (b, h, hk, n_local, ring_size, causal, striped, window, passes,
#        softclamp, key mask, Pallas block)
KERNEL_CASES = {
    "plain": (2, 4, 4, 16, 4, True, False, None, None, None, False, None),
    "striped": (2, 4, 4, 16, 4, True, True, None, None, None, False, None),
    "windowed_limited_passes": (2, 4, 4, 16, 4, True, False, 20, 3, None, False, None),
    "gqa_h4_hk2_striped_window": (2, 4, 2, 16, 4, True, True, 5, None, None, False, None),
    # non-causal with a padded key set; batch row 1 has no key at all
    "key_padding_all_false_row": (2, 4, 4, 16, 4, False, False, None, None, None, True, None),
    "softclamp": (2, 4, 4, 16, 4, True, False, None, None, 2.0, False, None),
    # four 16 x 16 Pallas tiles per hop: the band decides which tiles run
    "multi_tile_striped_window": (2, 4, 2, 64, 4, True, True, 70, None, None, False, 16),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_fused_ring_local_equals_pallas(case):
    b, h, hk, n, ring_size, causal, striped, window, passes, clamp, masked, block = (
        KERNEL_CASES[case])
    rng = np.random.default_rng(11)
    q = _np((b, h, n, d := 16), rng)
    k, v = _np((b, hk, ring_size * n, d), rng), _np((b, hk, ring_size * n, d), rng)
    mask = None
    if masked:
        mask = rng.random((b, ring_size * n)) > 0.3
        mask[1] = False
    kw = dict(n_local=n, scale=d ** -0.5, softclamp_value=clamp)
    for rank in range(ring_size):
        geo = (rank, passes or ring_size, n, causal, striped, window, ring_size)
        tables = dict(zip(("origins", "his", "los", "works"), pring._fused_tables(*geo)))
        out, lse = cuda_ring.fused_ring_local(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            None if mask is None else torch.from_numpy(mask), **tables, **kw)
        jtables = {name: jnp.asarray(t.numpy()) for name, t in tables.items()}
        jout, jlse = jpr.fused_ring_local(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask), **jtables, **kw,
            block_q=block, block_k=block, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                                   err_msg=f"out, rank {rank}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                                   rtol=1e-6, err_msg=f"lse, rank {rank}")


def test_fused_ring_local_checks_its_inputs():
    x = torch.zeros((1, 2, 8, 16))
    span = torch.zeros((1, 2, 32, 16))
    tables = dict(zip(("origins", "his", "los", "works"),
                      pring._fused_tables(0, 4, 8, True, False, None, 4)))
    with pytest.raises(ValueError, match="n_local"):
        cuda_ring.fused_ring_local(x, span, span, **tables, n_local=16, scale=1.0)
    with pytest.raises(ValueError, match="multiple of"):
        cuda_ring.fused_ring_local(x, span[:, :, :30], span[:, :, :30], **tables,
                                   n_local=8, scale=1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_ring._launch(x, span, span, None, tuple(tables.values()), 1.0, None)


# ---------------------------------------------------------------------------
# (c, d) the ring: VirtualRing vs the JAX fused ring under shard_map, and vs
# the port's own impl="cuda" ring
# ---------------------------------------------------------------------------


def _jax_ring(q, k, v, mask, do, *, ring_size, striped, **kw):
    """Output and (dq, dk, dv) of the JAX ring on a (data, ring) mesh of
    the virtual CPU devices, in the natural sequence order."""
    data = 8 // ring_size if q.shape[0] % (8 // ring_size) == 0 else 1
    mesh = jax_create_mesh(ring_size=ring_size, data_size=data,
                           devices=jax.devices()[:ring_size * data])
    fn = partial(jax_ring, axis_name="seq", striped=striped, **kw)
    qspec, mspec = P("data", None, "seq", None), P("data", "seq")
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(qspec, qspec, qspec, mspec if mask is not None else P()),
        out_specs=qspec, check_vma=False,  # the Pallas kernels
    )
    perm = (lambda x: jsharding.stripe_permute(x, ring_size, axis=2)) if striped else (lambda x: x)
    unperm = (lambda x: jsharding.stripe_unpermute(x, ring_size, axis=2)) if striped else (lambda x: x)
    jmask = None if mask is None else jnp.asarray(mask)

    def run(q, k, v):
        return unperm(sharded(perm(q), perm(k), perm(v), jmask))

    out, vjp = jax.vjp(run, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(q, k, v, mask, do, *, ring_size, striped, **kw):
    ring = VirtualRing(ring_size)
    perm = (lambda x: stripe_permute(x, ring_size, axis=2)) if striped else (lambda x: x)
    unperm = (lambda x: stripe_unpermute(x, ring_size, axis=2)) if striped else (lambda x: x)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = unperm(ring_flash_attention(
        perm(qt), perm(kt), perm(vt),
        None if mask is None else torch.from_numpy(mask), ring,
        striped=striped, **kw,
    ))
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


# name: (ring_size, (b, h, hk, n, d), masked, ring kwargs)
RING_CASES = {
    "causal": (4, (2, 4, 4, 64, 16), False, dict(causal=True)),
    "striped_gqa_h4_hk2": (4, (2, 4, 2, 64, 16), False, dict(causal=True, striped=True)),
    # window 20 over shards of 16: 3 passes; the dk/dv catch-up rotation
    "window_limited_passes": (4, (2, 4, 4, 64, 16), False,
                              dict(causal=True, window=20, max_ring_passes=3)),
    "striped_window": (4, (2, 4, 4, 64, 16), False,
                       dict(causal=True, striped=True, window=11)),
    # a shard with no valid key
    "kv_mask": (4, (2, 4, 4, 64, 16), True, dict()),
    "softclamp": (4, (2, 4, 4, 64, 16), False, dict(causal=True, softclamp_value=2.0)),
    "ring_of_one": (1, (2, 4, 2, 32, 16), False, dict(causal=True)),
}
# the JAX fused ring under shard_map costs ~13 s a case on the CPU: these
# cover every ring feature between them (the rest are held to impl="cuda")
JAX_CASES = ("striped_gqa_h4_hk2", "window_limited_passes", "kv_mask", "softclamp")


def _ring_inputs(case, seed=0):
    ring_size, (b, h, hk, n, d), masked, kw = RING_CASES[case]
    rng = np.random.default_rng(seed)
    q, do = _np((b, h, n, d), rng), _np((b, h, n, d), rng)
    k, v = _np((b, hk, n, d), rng), _np((b, hk, n, d), rng)
    mask = None
    if masked:
        mask = rng.random((b, n)) > 0.3
        mask[-1, : n // ring_size] = False
    kw = dict(kw)
    striped = kw.pop("striped", False)
    return q, k, v, mask, do, dict(ring_size=ring_size, striped=striped, **kw)


@pytest.mark.parametrize("case", JAX_CASES)
def test_fused_ring_equals_jax_fused_ring(case):
    q, k, v, mask, do, kw = _ring_inputs(case)
    jout, jgrads = _jax_ring(q, k, v, mask, do, impl="fused", bucket_size=16, **kw)
    out, grads = _port_ring(q, k, v, mask, do, impl="fused", **kw)
    np.testing.assert_allclose(out, jout, atol=ATOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(RING_CASES))
def test_fused_ring_equals_cuda_ring(case):
    q, k, v, mask, do, kw = _ring_inputs(case, seed=1)
    out, grads = _port_ring(q, k, v, mask, do, impl="fused", **kw)
    ref, ref_grads = _port_ring(q, k, v, mask, do, impl="cuda", **kw)
    np.testing.assert_array_equal(out, ref)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_array_equal(g, r, err_msg=f"d{name}")


def _spy_ring_calls(monkeypatch) -> list:
    """Record the kernel wrappers the ring calls (they run their plain
    versions here)."""
    calls = []
    for name in ("fused_ring_remote", "fused_ring_local", "flash_partials",
                 "flash_fwd", "flash_bwd"):
        real = getattr(pring, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(pring, name, spy)
    return calls


def test_fused_ring_launches_once_per_rank(monkeypatch):
    """Unmasked on a VirtualRing: one remote-tier launch for the whole ring
    (every rank's forward), nothing of the local tier or the hop-by-hop
    forward; the backward runs the kernels' per-hop backward."""
    calls = _spy_ring_calls(monkeypatch)
    rng = np.random.default_rng(4)
    x = [torch.from_numpy(_np((1, 2, 32, 16), rng)).requires_grad_() for _ in range(3)]
    for striped, backward in ((False, 10), (True, 16)):
        calls.clear()
        out = ring_flash_attention(*x, None, VirtualRing(4), causal=True,
                                   striped=striped, impl="fused")
        assert calls == ["fused_ring_remote"]
        out.sum().backward()
        assert calls[1:] == ["flash_bwd"] * backward


def test_fused_ring_masked_launches_local_once_per_rank(monkeypatch):
    """With a key mask the ring takes the local tier: one launch per rank
    over the gathered span, as in the JAX package."""
    calls = _spy_ring_calls(monkeypatch)
    rng = np.random.default_rng(4)
    x = [torch.from_numpy(_np((1, 2, 32, 16), rng)).requires_grad_() for _ in range(3)]
    mask = torch.from_numpy(rng.random((1, 32)) > 0.3)
    for striped, backward in ((False, 10), (True, 16)):
        calls.clear()
        out = ring_flash_attention(*x, mask, VirtualRing(4), causal=True,
                                   striped=striped, impl="fused")
        assert calls == ["fused_ring_local"] * 4
        out.sum().backward()
        assert calls[4:] == ["flash_bwd"] * backward


def test_fused_ring_cross_attention_bypasses_the_ring():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_np((2, 4, 64, 16), rng))
    k, v = (torch.from_numpy(_np((2, 4, 32, 16), rng)) for _ in range(2))
    ring = VirtualRing(4)
    np.testing.assert_array_equal(
        ring_flash_attention(q, k, v, None, ring, impl="fused").numpy(),
        ring_flash_attention(q, k, v, None, ring, impl="cuda").numpy())


def test_fused_ring_options():
    """counter_rotate has no fused form (a ValueError, as in JAX); the int8
    feed is ported (K4), and so are the dk/dv dtype, which the fused
    forward's backward takes (the same gradients as the scan ring's), and
    bidirectional, which the fused kernels drop with JAX's warning."""
    x = torch.randn((1, 2, 8, 16), generator=torch.Generator().manual_seed(0))
    ring = VirtualRing(2)
    with pytest.raises(ValueError, match="counter-rotation"):
        ring_flash_attention(x, x, x, None, ring, impl="fused", counter_rotate=True)
    grads = {}
    for impl in ("fused", "cuda"):
        qkv = [x.clone().requires_grad_() for _ in range(3)]
        ring_flash_attention(*qkv, None, ring, impl=impl, causal=True,
                             dkv_dtype="bfloat16").sum().backward()
        grads[impl] = [t.grad for t in qkv]
    for a, b in zip(grads["fused"], grads["cuda"]):
        assert torch.equal(a, b)
    with pytest.warns(UserWarning, match='impl="fused" circulates whole KV blocks'):
        out = ring_flash_attention(x, x, x, None, ring, impl="fused", bidirectional=True)
    assert torch.equal(out, ring_flash_attention(x, x, x, None, ring, impl="fused"))


def test_virtual_ring_all_gather():
    ring = VirtualRing(3)
    payloads = [(torch.full((1, 2), r), torch.full((2, 1), 10 + r)) for r in range(3)]
    gathered = ring.all_gather(payloads, dim=1)
    assert len(gathered) == 3
    for a, b in gathered:
        assert a.tolist() == [[0, 0, 1, 1, 2, 2]]
        assert b.tolist() == [[10, 11, 12], [10, 11, 12]]


# ---------------------------------------------------------------------------
# (e) the model
# ---------------------------------------------------------------------------

CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2,
              dim_head=16, causal=True, bucket_size=16, striped=True)


def _tokens(seed, b=2, n=128):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _assert_trees_close(got, ref, **tol):
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_got) == set(flat_ref)
    for path, r in flat_ref.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(r), err_msg=str(path), **tol)


@functools.cache
def _jax_fused_model():
    """The JAX model with impl="fused" on its mesh: weights, logits, loss
    and gradients, and the parameters after three SGD steps."""
    jm = JaxTransformer(**CONFIG, impl="fused",
                        mesh=jax_create_mesh(ring_size=4, data_size=2))
    resilience.reset()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the CPU degradation
            params = jm.init(jax.random.PRNGKey(0), jnp.asarray(_tokens(0)))
            params = jax.tree_util.tree_map(np.asarray, params)
            logits = np.asarray(jm.apply(params, jnp.asarray(_tokens(2, n=127))))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jm.apply(p, jnp.asarray(_tokens(1)), return_loss=True)))(params)
            lr = 0.5
            jstep = jax.jit(jax_make_train_step(
                lambda p, t: jm.apply(p, t, return_loss=True), optax.sgd(lr)))
            jparams, jstate, losses = params, optax.sgd(lr).init(params), []
            for seed in (3, 4, 5):
                jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(_tokens(seed)))
                losses.append(float(jloss))
    finally:
        resilience.reset()
    return params, logits, float(loss), grads, jparams, losses


def _port_model(params):
    tm = RingTransformer(**CONFIG, impl="fused", device="cpu",
                         mesh=create_mesh(ring_size=4))
    return load_jax_params(tm, params)


def test_fused_model_logits_loss_and_grads_match_jax():
    params, logits, ref_loss, ref_grads, _, _ = _jax_fused_model()
    tm = _port_model(params)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(_tokens(2, n=127))).numpy(),
                                   logits, atol=1e-5)
    loss = tm(torch.from_numpy(_tokens(1)), return_loss=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    holder = copy.deepcopy(tm)
    with torch.no_grad():
        for p, src in zip(holder.parameters(), tm.parameters()):
            p.copy_(src.grad)
    _assert_trees_close(export_jax_params(holder), ref_grads, **GRAD_TOL)


def test_fused_model_sgd_steps_match_jax():
    params, _, _, _, jparams, jlosses = _jax_fused_model()
    tm = _port_model(params)
    step = make_train_step(lambda t: tm(t, return_loss=True),
                           torch.optim.SGD(tm.parameters(), lr=0.5))
    for seed, jloss in zip((3, 4, 5), jlosses):
        np.testing.assert_allclose(float(step(torch.from_numpy(_tokens(seed)))),
                                   jloss, rtol=1e-5)
    _assert_trees_close(export_jax_params(tm), jparams, **GRAD_TOL)


def test_fused_model_export_round_trips():
    """export_jax_params carries the fused model's weights unchanged: B7
    adds no parameter."""
    params = _jax_fused_model()[0]
    _assert_trees_close(export_jax_params(_port_model(params)), params, atol=0, rtol=0)


def test_fused_model_local_paths_run_as_cuda():
    """Off the ring, impl="fused" is impl="cuda": the same logits, and
    decode through the same kernels (plain versions here)."""
    kw = dict(CONFIG, striped=False)
    fused = RingTransformer(**kw, impl="fused", device="cpu")
    cuda = RingTransformer(**kw, impl="cuda", device="cpu")
    cuda.load_state_dict(fused.state_dict())
    tokens = torch.from_numpy(_tokens(6, b=1, n=40)).long()
    with torch.no_grad():
        assert torch.equal(fused(tokens), cuda(tokens))
        assert torch.equal(fused.generate(tokens, max_len=48, num_steps=4),
                           cuda.generate(tokens, max_len=48, num_steps=4))
