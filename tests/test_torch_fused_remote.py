"""Parity: the port's fused ring, remote tier (TPU kernel B8), on the CPU.

The same numpy inputs go through the JAX package and the port:

- the kernel function: ``ops/cuda_ring_remote.py::fused_ring_remote`` on
  CPU tensors (its plain version: the port's hop chain fed by circulating
  every rank's KV through two slots) for every rank against
  ``ops/pallas_ring.py::fused_ring_local(..., interpret=True)`` over the
  gathered span with the same tables (the remote tier computes the local
  tier's function; JAX's remote tier cannot execute on the CPU), out and
  lse to ``test_torch_fused_ring.py``'s ``ATOL = 2e-5``;
- the ring: ``ring_flash_attention(impl="fused")`` on an unmasked
  ``VirtualRing`` (the remote tier) against the port's ``impl="cuda"``
  ring bit for bit, and against the JAX fused ring under ``shard_map``
  (forward ``ATOL``, gradients ``GRAD_ATOL = 5e-4``);
- which tier runs: the remote tier once for the whole ring without a mask
  on a ``VirtualRing``, the local tier per rank with a mask, on a ring
  whose ranks one launch cannot address, and on a ring of one;
- the protocol: the port's ``PROTOCOL`` table through the JAX model check
  ``ring_attention_tpu.analysis.schedverify`` (read-only), clean, and its
  grant-less and logical-id variants failing with the verifier's rules;
  every row's ``fn`` a ``__device__`` function of the CUDA source.
"""

import contextlib
import functools
import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ring_attention_tpu.analysis import schedverify
from ring_attention_tpu.ops import pallas_ring as jpr
from ring_attention_tpu.parallel import create_mesh as jax_create_mesh
from ring_attention_tpu.parallel import ring_flash_attention as jax_ring
from ring_attention_tpu.utils.compat import shard_map
from ring_attention_tpu_torch.ops import _build, cuda_ring_remote
from ring_attention_tpu_torch.ops.cuda_flash_q8 import kernel_kv
from ring_attention_tpu_torch.ops.quant import quantize_kv_blocks
from ring_attention_tpu_torch.parallel import DistributedRing, VirtualRing, ring_flash_attention
from ring_attention_tpu_torch.parallel import ring as pring

ATOL = 2e-5
GRAD_ATOL = 5e-4
SOURCE = Path(cuda_ring_remote.__file__).resolve().parents[1] / "csrc" / "flash_ring_remote.cu"


def _np(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _tables(ring_size, n, causal=True, striped=False, window=None, passes=None):
    return [pring._fused_tables(rank, passes or ring_size, n, causal, striped, window,
                                ring_size)
            for rank in range(ring_size)]


# ---------------------------------------------------------------------------
# (a) the kernel function: plain version vs the Pallas local kernel
# ---------------------------------------------------------------------------

# name: (ring_size, (b, h, hk, n_local, d), striped, window, passes, softclamp)
KERNEL_CASES = {
    **{f"ring{w}_{layout}": (w, (1, 4, 4, 16, 16), layout == "striped", None, None, None)
       for w in (2, 3, 4, 8) for layout in ("contiguous", "striped")},
    # 20 tokens back over shards of 16: 3 of 4 passes
    "window20_3_passes": (4, (2, 4, 4, 16, 16), False, 20, 3, None),
    "gqa_h4_hk2_striped_window": (4, (2, 4, 2, 16, 16), True, 5, None, None),
    "softclamp": (4, (2, 4, 4, 16, 16), False, None, None, 2.0),
}


def _kernel_inputs(case):
    ring_size, (b, h, hk, n, d), striped, window, passes, clamp = KERNEL_CASES[case]
    rng = np.random.default_rng(21)
    q = _np((b, h, ring_size * n, d), rng)
    k, v = _np((b, hk, ring_size * n, d), rng), _np((b, hk, ring_size * n, d), rng)
    tables = _tables(ring_size, n, striped=striped, window=window, passes=passes)
    return q, k, v, tables, dict(n_local=n, scale=d ** -0.5, softclamp_value=clamp)


@functools.cache
def _jax_ranks(case):
    """Every rank's (out, lse) from the JAX local-tier kernel in interpret
    mode over the gathered span."""
    q, k, v, tables, kw = _kernel_inputs(case)
    n = kw["n_local"]
    results = []
    for rank, table in enumerate(tables):
        jtables = {name: jnp.asarray(t.numpy())
                   for name, t in zip(("origins", "his", "los", "works"), table)}
        out, lse = jpr.fused_ring_local(
            jnp.asarray(q[:, :, rank * n:(rank + 1) * n]), jnp.asarray(k), jnp.asarray(v),
            None, **jtables, **kw, interpret=True)
        results.append((np.asarray(out), np.asarray(lse)))
    return results


def _shards(x, ring_size):
    return [torch.from_numpy(np.ascontiguousarray(s)) for s in np.split(x, ring_size, axis=2)]


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_fused_ring_remote_equals_pallas(case):
    q, k, v, tables, kw = _kernel_inputs(case)
    ring_size = len(tables)
    outs, lses = cuda_ring_remote.fused_ring_remote(
        _shards(q, ring_size), _shards(k, ring_size), _shards(v, ring_size),
        tables=tables, **kw)
    for rank, ((out, lse), (jout, jlse)) in enumerate(zip(zip(outs, lses), _jax_ranks(case))):
        np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, err_msg=f"out, rank {rank}")
        np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL, rtol=1e-6,
                                   err_msg=f"lse, rank {rank}")


def test_plain_version_circulates_like_the_local_tier():
    """The plain version fed by circulation equals the local tier's plain
    version over the gathered span, bit for bit, rank by rank."""
    q, k, v, tables, kw = _kernel_inputs("gqa_h4_hk2_striped_window")
    ring_size, n = len(tables), kw["n_local"]
    outs, lses = cuda_ring_remote.fused_ring_remote_plain(
        _shards(q, ring_size), _shards(k, ring_size), _shards(v, ring_size),
        tables=tables, **kw)
    for rank, table in enumerate(tables):
        out, lse = pring.fused_ring_local(
            _shards(q, ring_size)[rank], torch.from_numpy(k), torch.from_numpy(v),
            **dict(zip(("origins", "his", "los", "works"), table)), **kw)
        assert torch.equal(outs[rank], out) and torch.equal(lses[rank], lse), rank


# ---------------------------------------------------------------------------
# (b) the ring: remote tier vs impl="cuda" and vs the JAX fused ring
# ---------------------------------------------------------------------------

# name: (ring_size, (b, h, hk, n, d), ring kwargs)
RING_CASES = {
    "ring2_causal": (2, (2, 4, 4, 32, 16), dict(causal=True)),
    "ring3_striped_gqa": (3, (2, 4, 2, 48, 16), dict(causal=True, striped=True)),
    "ring8_causal_window_5_passes": (8, (1, 4, 4, 64, 16),
                                     dict(causal=True, window=30, max_ring_passes=5)),
    "ring8_striped_softclamp": (8, (1, 4, 2, 64, 16),
                                dict(causal=True, striped=True, softclamp_value=2.0)),
    "ring4_not_causal": (4, (2, 4, 4, 64, 16), dict()),
}


def _ring_inputs(case, seed):
    ring_size, (b, h, hk, n, d), kw = RING_CASES[case]
    rng = np.random.default_rng(seed)
    q, do = _np((b, h, n, d), rng), _np((b, h, n, d), rng)
    k, v = _np((b, hk, n, d), rng), _np((b, hk, n, d), rng)
    return ring_size, q, k, v, do, kw


def _port_ring(ring, q, k, v, do, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_flash_attention(qt, kt, vt, None, ring, **kw)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("case", list(RING_CASES))
def test_remote_ring_equals_cuda_ring(case):
    ring_size, q, k, v, do, kw = _ring_inputs(case, seed=2)
    out, grads = _port_ring(VirtualRing(ring_size), q, k, v, do, impl="fused", **kw)
    ref, ref_grads = _port_ring(VirtualRing(ring_size), q, k, v, do, impl="cuda", **kw)
    np.testing.assert_array_equal(out, ref)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_array_equal(g, r, err_msg=f"d{name}")


@functools.cache
def _jax_fused_ring(case):
    ring_size, q, k, v, do, kw = _ring_inputs(case, seed=3)
    mesh = jax_create_mesh(ring_size=ring_size, data_size=1,
                           devices=jax.devices()[:ring_size])
    spec = P("data", None, "seq", None)
    ring = partial(jax_ring, axis_name="seq", impl="fused", bucket_size=8, **kw)
    fn = shard_map(lambda q, k, v: ring(q, k, v, None), mesh=mesh,
                   in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def test_remote_ring_equals_jax_fused_ring():
    """Contiguous causal ring of 8 with a window over 5 passes, forward and
    gradients (the JAX ring under shard_map costs ~10 s a case here)."""
    case = "ring8_causal_window_5_passes"
    ring_size, q, k, v, do, kw = _ring_inputs(case, seed=3)
    jout, jgrads = _jax_fused_ring(case)
    out, grads = _port_ring(VirtualRing(ring_size), q, k, v, do, impl="fused", **kw)
    np.testing.assert_allclose(out, jout, atol=ATOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=GRAD_ATOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# (c) which tier runs
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, names) -> list:
    calls = []
    for name in names:
        real = getattr(module, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


class _SeparateRing(VirtualRing):
    """A ring of this process whose ranks one launch cannot address, as a
    DistributedRing's cannot: the fused ring keeps the local tier."""

    colocated = False


def _x(ring_size, seed=6):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_np((1, 2, 8 * ring_size, 16), rng)) for _ in range(3)]


def test_the_ring_kinds_say_whether_one_launch_holds_them():
    assert VirtualRing(4).colocated is True
    assert DistributedRing.colocated is False
    assert _SeparateRing(4).colocated is False


@pytest.mark.parametrize("ring_size", [2, 3, 8])
def test_unmasked_virtual_ring_launches_the_remote_tier_once(monkeypatch, ring_size):
    calls = _spy(monkeypatch, pring, ("fused_ring_remote", "fused_ring_local"))
    with torch.no_grad():
        ring_flash_attention(*_x(ring_size), None, VirtualRing(ring_size), causal=True,
                             impl="fused")
    assert calls == ["fused_ring_remote"]


def test_masked_ring_and_separate_ranks_take_the_local_tier(monkeypatch):
    calls = _spy(monkeypatch, pring, ("fused_ring_remote", "fused_ring_local"))
    x = _x(4)
    mask = torch.ones((1, 32), dtype=torch.bool)
    mask[0, 5] = False
    with torch.no_grad():
        masked = ring_flash_attention(*x, mask, VirtualRing(4), causal=True, impl="fused")
        assert calls == ["fused_ring_local"] * 4
        calls.clear()
        separate = ring_flash_attention(*x, None, _SeparateRing(4), causal=True,
                                        impl="fused")
        assert calls == ["fused_ring_local"] * 4
        calls.clear()
        remote = ring_flash_attention(*x, None, VirtualRing(4), causal=True, impl="fused")
    assert calls == ["fused_ring_remote"]
    assert torch.equal(separate, remote)  # the two tiers: one function
    assert not torch.equal(masked, remote)


def test_ring_of_one_moves_nothing(monkeypatch):
    calls = _spy(monkeypatch, pring, ("fused_ring_remote", "fused_ring_local"))
    ring = VirtualRing(1)
    moves = _spy(monkeypatch, ring, ("rotate", "all_gather"))
    x = [t.requires_grad_() for t in _x(1)]
    out = ring_flash_attention(*x, None, ring, causal=True, impl="fused")
    out.sum().backward()
    assert calls == ["fused_ring_local"]
    assert moves == []


def test_balanced_split():
    """Blocks per rank minimize the modelled launch of the card's 132 blocks
    (one an SM) over 128-row items: on a contiguous causal ring of 4 (work
    0.5 : 1.5 : 2.5 : 3.5) the grant couples the ranks hop by hop, so the
    split in proportion to total work is slower than an even one, and the
    balanced split beats both."""
    tables = _tables(4, 16384)
    split = cuda_ring_remote.balanced_split(tables, 16384, 8, 132)
    span = partial(cuda_ring_remote.modelled_time, tables, 16384, 8)
    assert sum(split) == 132
    assert span(split) < span([33] * 4) < span([8, 25, 41, 58])
    striped = _tables(4, 16384, striped=True)
    striped_split = cuda_ring_remote.balanced_split(striped, 16384, 8, 132)
    assert sum(striped_split) == 132
    assert (cuda_ring_remote.modelled_time(striped, 16384, 8, striped_split)
            <= cuda_ring_remote.modelled_time(striped, 16384, 8, [33] * 4))
    # every rank keeps a block, whatever its share
    assert cuda_ring_remote.balanced_split(tables, 16384, 8, 4) == [1, 1, 1, 1]
    # the f32 kernel's 64-row tiles are modelled as such
    assert (cuda_ring_remote.modelled_time(tables, 16384, 8, [33] * 4, rows=64)
            > span([33] * 4))


def _band_tiles_brute(hi, lo, n, r0):
    """The KV tiles a 64-row warpgroup from r0 visits, counted key by key:
    those holding a key of some row's band, or every tile when a row's band
    is empty (csrc/flash_tile.cuh band_tiles); none past n."""
    rows = range(r0, min(r0 + 64, n))
    if not rows:
        return 0
    tiles = set()
    for i in rows:
        keys = range(max(0, i + lo), min(n - 1, i + hi) + 1)
        if not keys:
            return -(-n // 64)
        tiles.update(j // 64 for j in keys)
    return len(tiles)


def test_tile_visits_and_block_time():
    """The host's count of the kernel's walk: KV tiles per 128-row query
    item, the larger of its two warpgroups' ``band_tiles`` sets (brute
    force, key by key, on a shard of whole items and a ragged one), and the
    largest block's share of a hop under the kernel's item order
    (``item_coords``, ``snake_tile``)."""
    for n, hi, lo in [(n, hi, lo) for n in (256, 300)
                      for hi, lo in ((n, -n), (0, -n), (0, -100), (-1, -n), (-5 * n, -n),
                                     (n, 3 * n), (70, 10), (-64, -200))]:
        expected = [max(_band_tiles_brute(hi, lo, n, r0), _band_tiles_brute(hi, lo, n, r0 + 64))
                    for r0 in range(0, n, 128)]
        assert cuda_ring_remote._tile_visits(hi, lo, n).tolist() == expected, (hi, lo)
        tiles64 = [_band_tiles_brute(hi, lo, n, r0) for r0 in range(0, n, 64)]
        assert cuda_ring_remote._tile_visits(hi, lo, n, rows=64).tolist() == tiles64, (hi, lo)
    # items 2, 4, 6, 8 (heaviest last) over 2 heads dealt to 3 blocks:
    # [8, 8, 6], then [6, 4, 4] backward, then [2, 2]: the blocks walk
    # 8 + 4 + 2, 8 + 4 + 2 and 6 + 6
    visits = cuda_ring_remote._tile_visits(0, -512, 512)
    assert visits.tolist() == [2, 4, 6, 8]
    assert cuda_ring_remote._block_time(visits, 2, 3) == 14
    # the kernel's walk, item by item, for other block counts
    for bh, blocks in ((8, 5), (3, 7), (1, 4)):
        items, q_items = bh * len(visits), len(visits)
        per_block = []
        for c in range(blocks):
            j, walked = 0, 0
            while (item := j * blocks + (blocks - 1 - c if j % 2 else c)) < items:
                walked += int(visits[q_items - 1 - item // bh])
                j += 1
            per_block.append(walked)
        assert cuda_ring_remote._block_time(visits, bh, blocks) == max(per_block)


def test_grid_blocks_and_capacity(monkeypatch):
    """The default grid: every block the card holds at once (the occupancy
    query at the kernel's block size and dynamic shared memory: one bf16
    block an SM), but no more than the ring's query items, 128 rows each in
    bf16 and 64 in f32."""
    grid = cuda_ring_remote._grid_blocks
    assert grid(132, 4, 8, 16384, True) == 132
    assert grid(132, 4, 1, 1000, True) == 4 * 8  # 8 items of 128 rows a rank
    assert grid(132, 4, 1, 1000, False) == 4 * 16  # 16 tiles of 64 rows
    assert grid(528, 2, 1, 1, True) == 2

    class Lib:
        calls = []

        def flash_ring_remote_capacity(self, is_bf16, clamp, blocks):
            self.calls.append((is_bf16, clamp))
            blocks._obj.value = {1: 132, 0: 4 * 132}[is_bf16]
            return 0

    monkeypatch.setattr(_build, "flash_ring_remote_library", lambda: Lib())
    monkeypatch.setattr(cuda_ring_remote.torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    capacity = cuda_ring_remote._capacity.__wrapped__
    assert capacity(0, True, False) == 132 and capacity(0, False, True) == 528
    assert Lib.calls == [(1, 0), (0, 1)]
    Lib.flash_ring_remote_capacity = lambda self, b, c, blocks: 2  # a CUDA error
    with pytest.raises(RuntimeError, match="occupancy query failed: CUDA error 2"):
        capacity(0, True, False)
    Lib.flash_ring_remote_capacity = lambda self, b, c, blocks: 0  # no cooperative launch
    with pytest.raises(RuntimeError, match="cannot launch cooperatively"):
        capacity(0, True, False)


def test_kernel_sizes_its_cooperative_grid_with_its_shared_memory():
    """The occupancy query and the cooperative launch both take the
    dynamic shared memory the kernel is allowed: with 0 bytes the query
    would count blocks that cannot be resident at once."""
    source = SOURCE.read_text()
    assert re.search(r"cudaOccupancyMaxActiveBlocksPerMultiprocessor\(&per_sm, kernel, "
                     r"threads, smem\)", source)
    launch = source.split("cudaLaunchCooperativeKernel(", 1)[1].split(";", 1)[0]
    assert re.search(r"args,\s*smem,", launch), launch
    setter = source.split("cudaError_t kernel_of(", 1)[1].split("\n}\n", 1)[0]
    assert "*smem = is_bf16 ? kFwdSmem : 0;" in setter
    assert "cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem)" \
        in setter


# ---------------------------------------------------------------------------
# (d) the protocol
# ---------------------------------------------------------------------------


def test_protocol_model_checks_clean():
    assert schedverify.verify_protocol(protocol=cuda_ring_remote.PROTOCOL) == []


def test_protocol_without_grants_races():
    grantless = tuple(r for r in cuda_ring_remote.PROTOCOL
                      if r["row"] not in ("push-grant", "grant"))
    found = schedverify.verify_ring(grantless, ring=4)
    assert found and all("[rule: slot-overwrite-race]" in v for v in found), found[:3]


def test_protocol_with_logical_ids_escapes_the_replica_group():
    logical = tuple({**r, "addressing": "logical"} if r["row"] == "push-kv" else r
                    for r in cuda_ring_remote.PROTOCOL)
    assert schedverify.verify_ring(logical, ring=4) == []  # one group hides it
    found = schedverify.verify_ring(logical, ring=4, groups=2)
    assert any("[rule: dma-device-id]" in v for v in found), found[:3]


def test_protocol_rows_name_device_functions_of_the_kernel():
    source = SOURCE.read_text()
    for row in cuda_ring_remote.PROTOCOL:
        pattern = rf"__device__[^;{{]*\b{row['fn']}\s*\("
        assert re.search(pattern, source), (row["row"], row["fn"])
    kinds = {r["op"] for r in cuda_ring_remote.PROTOCOL}
    assert kinds == {"copy", "remote_copy", "sem_wait", "sem_signal"}


# ---------------------------------------------------------------------------
# (e) input checks
# ---------------------------------------------------------------------------


def test_fused_ring_remote_checks_its_inputs():
    x, n = _x(4), 8
    qs, ks, vs = (list(t.split(n, dim=2)) for t in x)
    qs, ks, vs = ([s.contiguous() for s in part] for part in (qs, ks, vs))
    kw = dict(tables=_tables(4, n), n_local=n, scale=1.0)
    with pytest.raises(ValueError, match="no key mask"):
        cuda_ring_remote.fused_ring_remote(qs, ks, vs, [torch.ones(1, n, dtype=torch.bool)] * 4,
                                           **kw)
    # the int8 wire is ported: it takes one feed per rank, with one v block
    # of n_local keys
    with pytest.raises(ValueError, match="one kv_quantized feed per rank"):
        cuda_ring_remote.fused_ring_remote(qs, ks, vs, compute_dtype="int8", **kw)
    feeds = [kernel_kv(quantize_kv_blocks(k, v, n // 2)) for k, v in zip(ks, vs)]
    with pytest.raises(ValueError, match="one v block of 8 keys"):
        cuda_ring_remote.fused_ring_remote(qs, None, None, compute_dtype="int8",
                                           kv_quantized=feeds, **kw)
    with pytest.raises(ValueError, match="goes with"):
        cuda_ring_remote.fused_ring_remote(qs, ks, vs, kv_quantized=feeds, **kw)
    with pytest.raises(ValueError, match="float operands"):
        cuda_ring_remote.fused_ring_remote([q.to(torch.int8) for q in qs],
                                           [k.to(torch.int8) for k in ks],
                                           [v.to(torch.int8) for v in vs], **kw)
    with pytest.raises(ValueError, match="mismatched shards"):
        cuda_ring_remote.fused_ring_remote(qs, ks[:3] + [ks[3][:, :1]], vs, **kw)
    with pytest.raises(ValueError, match="one of each per rank"):
        cuda_ring_remote.fused_ring_remote(qs, ks[:3], vs, **kw)
    with pytest.raises(ValueError, match="circulation order"):
        cuda_ring_remote.fused_ring_remote(qs, ks, vs, **dict(kw, tables=kw["tables"][::-1]))
    idle = [(o, hi, lo, torch.zeros_like(w)) for o, hi, lo, w in kw["tables"]]
    with pytest.raises(ValueError, match="no hop with work"):
        cuda_ring_remote.fused_ring_remote(qs, ks, vs, **dict(kw, tables=idle))
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_ring_remote._launch(qs, ks, vs, kw["tables"], 1.0, None, None)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA launch builds the kernel first; with no nvcc that raises,
    naming it, and nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.flash_ring_remote_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_ring_remote._capacity.__wrapped__(0, True, False)
    finally:
        _build.flash_ring_remote_library.cache_clear()
