"""Parity: the port's tree-attention decoding and its model decode on a
mesh vs the JAX package's.

The JAX side runs ``tree_attn_decode`` under ``shard_map`` on
``create_mesh(ring_size=4)`` of the 8 virtual CPU devices (a 2 x 4 mesh),
as ``tests/test_tree_decode.py`` does, with ``impl="xla"`` and
``impl="pallas"`` (the decode kernel in interpret mode), and the int8 cache
on its q8 kernel; the port's on a ``VirtualRing`` of 4, ``impl="torch"``
held to ``"xla"`` and ``impl="cuda"`` (B5's partials; the wrapper runs its
plain version on CPU tensors) to ``"pallas"``.  Covered: 8 and 2 kv heads,
a padded cache whose last shard holds no valid key, several queries, a
cache in which three of the four ranks hold no valid key, an int8 cache
(B6's partials), and ``impl="torch"`` on an int8 cache (dequantized).
Then the ``RingTransformer`` on a mesh: prefill, teacher-forced decode
steps and greedy ``generate`` against the JAX model on its mesh, in f32,
for the plain and striped models and ``quantize_cache=True``, under each
port impl.  Each JAX reference is computed once (``functools.cache``).

Tolerances: decode outputs 1e-5 absolute; the int8 cache 3e-5
(``tests/test_torch_q8.py``); model logits 1e-4 absolute
(``tests/test_torch_model.py``: f32 through two layers and a 256-way
projection).
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.models import RingTransformer as JaxTransformer
from ring_attention_tpu.ops.pallas_flash import QuantizedKV as JaxQuantizedKV
from ring_attention_tpu.ops.pallas_flash import quantize_kv_cache as jax_quantize_kv_cache
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import tree_attn_decode as jax_tree_attn_decode
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch import QuantizedKV, RingTransformer, load_jax_params
from ring_attention_tpu_torch.parallel import VirtualRing, create_mesh, tree_attn_decode

RING = 4
OUT_ATOL = 1e-5
Q8_ATOL = 3e-5
LOGITS_ATOL = 1e-4
JAX_IMPL = {"torch": "xla", "cuda": "pallas"}
# name: (b, h, hk, nq, n, d, valid keys or None, bucket_size)
CASES = {
    "hk8": (2, 8, 8, 1, 256, 16, None, None),
    "hk2": (2, 8, 2, 1, 256, 16, None, None),
    # 40 valid slots of 64: rank 2 is partly valid, rank 3 holds none
    "padded_cache": (2, 4, 4, 1, 64, 16, 40, None),
    "multi_query": (2, 4, 4, 4, 128, 16, None, 8),
    # a prompt shorter than rank 0's shard: ranks 1-3 hold no valid key
    "empty_ranks": (2, 8, 2, 1, 128, 16, 5, 8),
}


def _inputs(case, seed=0):
    b, h, hk, nq, n, d, valid, _ = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    mask = None
    if valid is not None:
        mask = np.broadcast_to(np.arange(n)[None, :] < valid, (b, n)).copy()
    return q, k, v, mask


def _jax_decode(q, k, v, mask, impl, bucket, kv_quantized=None):
    mesh = jax_create_mesh(ring_size=RING)
    kspec, sspec = P("data", None, "seq", None), P("data", None, "seq")
    args, specs = [jnp.asarray(q)], [P("data")]
    if kv_quantized is None:
        args += [jnp.asarray(k), jnp.asarray(v)]
        specs += [kspec, kspec]
    if mask is not None:
        args.append(jnp.asarray(mask))
        specs.append(P("data", "seq"))
    if kv_quantized is not None:
        args.append(kv_quantized)
        specs.append(JaxQuantizedKV(kspec, sspec, kspec, sspec))

    def core(*a):
        a = list(a)
        kv = a.pop() if kv_quantized is not None else None
        q, rest = a[0], a[1:]
        k, v = (rest.pop(0), rest.pop(0)) if kv is None else (None, None)
        m = rest[0] if rest else None
        return jax_tree_attn_decode(q, k, v, m, axis_name="seq", impl=impl,
                                    bucket_size=bucket, kv_quantized=kv)

    return np.asarray(shard_map(core, mesh=mesh, in_specs=tuple(specs),
                                out_specs=P("data"),
                                check_vma=False)(*args))


@functools.cache
def _jax_reference(case, impl):
    q, k, v, mask = _inputs(case)
    return _jax_decode(q, k, v, mask, impl, CASES[case][-1])


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _ranks(x, dim):
    """Each rank's shard of the whole cache ``x`` along ``dim``, one
    contiguous tensor a rank (the form ``tree_attn_decode`` takes)."""
    return None if x is None else [s.contiguous() for s in _t(x).chunk(RING, dim)]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_tree_decode_matches_jax(case, impl):
    q, k, v, mask = _inputs(case)
    out = tree_attn_decode(_t(q), _ranks(k, 2), _ranks(v, 2), _ranks(mask, 1),
                           ring=VirtualRing(RING),
                           impl=impl, bucket_size=CASES[case][-1])
    np.testing.assert_allclose(out.numpy(), _jax_reference(case, JAX_IMPL[impl]),
                               atol=OUT_ATOL)


@functools.cache
def _q8_case():
    """An int8 cache quantized by the JAX codec (the port reads the same
    values and scales), with a ragged validity mask; the JAX q8-kernel
    and dequantized (``impl="xla"``) references."""
    rng = np.random.default_rng(3)
    b, h, hk, n, d = 2, 8, 2, 256, 16
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hk, n, d)).astype(np.float32) for _ in range(2))
    mask = np.broadcast_to(np.arange(n)[None, :] < 200, (b, n)).copy()
    kv = jax_quantize_kv_cache(jnp.asarray(k), jnp.asarray(v))
    refs = {impl: _jax_decode(q, None, None, mask, impl, 16, kv_quantized=kv)
            for impl in (None, "xla")}
    return q, mask, [np.asarray(x) for x in kv], refs


@pytest.mark.parametrize("impl", [None, "torch"])
def test_tree_decode_int8_cache_matches_jax(impl):
    """``impl=None``: B6's partials (plain version here) against the JAX q8
    kernel; ``impl="torch"``: the cache dequantized and swept, against the
    JAX ``impl="xla"``."""
    q, mask, kv, refs = _q8_case()
    shards = [QuantizedKV(*x) for x in zip(*(_ranks(x, 2) for x in kv))]
    out = tree_attn_decode(_t(q), None, None, _ranks(mask, 1), ring=VirtualRing(RING),
                           impl=impl, kv_quantized=shards)
    np.testing.assert_allclose(out.numpy(), refs[None if impl is None else "xla"],
                               atol=Q8_ATOL)


def test_tree_decode_checks_its_arguments():
    q, k, v, _ = _inputs("hk2")
    q, k, v = _t(q), _ranks(k, 2), _ranks(v, 2)
    ring = VirtualRing(RING)
    kv = [QuantizedKV(a.to(torch.int8), a[..., 0], b.to(torch.int8), b[..., 0])
          for a, b in zip(k, v)]
    with pytest.raises(ValueError, match="either k/v or kv_quantized"):
        tree_attn_decode(q, k, v, ring=ring, kv_quantized=kv)
    with pytest.raises(ValueError, match="unknown impl"):
        tree_attn_decode(q, k, v, ring=ring, impl="pallas")
    with pytest.raises(ValueError, match="incompatible with int8 cache"):
        tree_attn_decode(q[:, :, :, :8], None, None, ring=ring, kv_quantized=kv)
    with pytest.raises(ValueError, match="3 k shards for the 4 ring ranks"):
        tree_attn_decode(q, k[:3], v[:3], ring=ring)


@pytest.mark.parametrize("variant", ["plain", "quantize_cache"])
def test_mesh_cache_shards_are_written_in_place(variant):
    """On a mesh each layer's cache is one contiguous tensor per rank's
    shard, which decoding reads and writes in place: a step at position
    10 of a 24-slot cache writes slot 4 of rank 1's shard and nothing
    else, and no shard is reallocated."""
    tm = RingTransformer(**CONFIG, **VARIANTS[variant], device="cpu",
                         mesh=create_mesh(ring_size=RING))
    tokens = torch.from_numpy(_tokens(1)).long()
    with torch.no_grad():
        cache = tm.init_cache(2, MAX_LEN)
        _, cache = tm.prefill(tokens[:, :PROMPT], cache)
        before = [[t.clone() for t in _tensors(e)] for e in cache["k"][0]]
        ptrs = [[t.data_ptr() for t in _tensors(e)] for e in cache["k"][0]]
        _, cache = tm.decode_step(tokens[:, PROMPT], cache, PROMPT)
    shards = cache["k"][0]
    assert len(shards) == RING
    for r, entry in enumerate(shards):
        for t, old, ptr in zip(_tensors(entry), before[r], ptrs[r]):
            assert t.is_contiguous() and t.shape[2] == MAX_LEN // RING
            assert t.data_ptr() == ptr
            diff = t != old
            changed = (diff.any(-1) if diff.ndim == 4 else diff).any(0).any(0)
            assert changed.nonzero().flatten().tolist() == ([4] if r == 1 else [])


def _tensors(entry):
    return entry if isinstance(entry, tuple) else (entry,)


# --- the RingTransformer's decode entries on a mesh --------------------------

CONFIG = dict(num_tokens=256, dim=64, depth=2, heads=4, kv_heads=2, dim_head=16,
              causal=True, bucket_size=8)
VARIANTS = {
    "plain": {},
    "striped": dict(striped=True),
    "quantize_cache": dict(quantize_cache=True),
}
MAX_LEN, PROMPT, STEPS = 24, 10, 6


def _tokens(seed, b=2, n=PROMPT + STEPS):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


@functools.cache
def _jax_serving(variant):
    """The JAX model on its 2 x 4 mesh: prefill logits, each teacher-forced
    decode step's logits, and greedy generate."""
    jm = JaxTransformer(**CONFIG, **VARIANTS[variant],
                        mesh=jax_create_mesh(ring_size=RING, data_size=2))
    tokens = _tokens(1)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens)))
    cache = jm.apply(params, 2, MAX_LEN, method=jm.init_cache)
    logits, cache = jax.jit(partial(jm.apply, method=jm.prefill))(
        params, jnp.asarray(tokens[:, :PROMPT]), cache)
    steps = [np.asarray(logits)]
    decode = jax.jit(partial(jm.apply, method=jm.decode_step))
    for pos in range(PROMPT, PROMPT + STEPS - 1):
        logits, cache = decode(params, jnp.asarray(tokens[:, pos]), cache, jnp.int32(pos))
        steps.append(np.asarray(logits))
    generate = jax.jit(partial(jm.apply, method=jm.generate), static_argnums=(2, 3))
    generated = np.asarray(generate(params, jnp.asarray(tokens[:, :PROMPT]), MAX_LEN, STEPS))
    return params, steps, generated


@pytest.mark.parametrize("impl", ["torch", "cuda", "fused"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mesh_prefill_decode_and_generate_match_jax(variant, impl):
    """A 10-token prompt fills ranks 0 and 1 of a 24-slot cache (6 a rank);
    ranks 2 and 3 hold no valid key until the decode steps reach them."""
    params, ref_steps, ref_generated = _jax_serving(variant)
    tm = load_jax_params(RingTransformer(**CONFIG, **VARIANTS[variant], impl=impl,
                                         device="cpu", mesh=create_mesh(ring_size=RING)),
                         params)
    tokens = torch.from_numpy(_tokens(1)).long()
    with torch.no_grad():
        cache = tm.init_cache(2, MAX_LEN)
        logits, cache = tm.prefill(tokens[:, :PROMPT], cache)
        steps = [logits.numpy()]
        for pos in range(PROMPT, PROMPT + STEPS - 1):
            logits, cache = tm.decode_step(tokens[:, pos], cache, pos)
            steps.append(logits.numpy())
    for i, (got, ref) in enumerate(zip(steps, ref_steps)):
        np.testing.assert_allclose(got, ref, atol=LOGITS_ATOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(
        tm.generate(tokens[:, :PROMPT], MAX_LEN, STEPS).numpy(), ref_generated)
